"""Serving traffic: a closed loop with one caller.

Set-up makes the configuration's tables and seen lists on the device
from the seed and builds the program's `serving.Recommender` with the
configuration's serving options; a few requests drawn from a stream of
their own warm it up. Each request of the window is `batch` distinct
users drawn uniformly from the seed (consecutive slices of seeded
permutations of all users) and calls
`recommend_certified(users, k, exclude_seen=True, fallback="exact")`;
the next request leaves when the last one's arrays are back.

`serve_qps` is the users answered over the window's wall time;
`serve_p95_ms` the 95th percentile of every request's latency, from the
call to the returned numpy arrays. The check judges a sample of the
answered rows drawn from the seed, with every row the certificate did
not certify (the rows the exact fallback answered) and each request's
user with the longest seen list in it, against the reference once the
Recommender is freed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import faults, yardstick

# the faults this kind's cells can have (`faults.py`)
FAULTS = {"half": faults.half_batch, "altered": faults.altered_id}

# offsets from the seed of the warm-up's and the check sample's draws (the
# requests draw from the seed itself)
_WARM, _SAMPLE = 0x5EED, 0xC4EC


class Batches:
    """Batches of distinct users: consecutive slices of seeded
    permutations of all n users."""

    def __init__(self, n: int, b: int, seed: int):
        self.n, self.b = n, b
        self.rng = np.random.default_rng(seed)
        self.perm, self.pos = None, n

    def next(self) -> np.ndarray:
        if self.pos + self.b > self.n:
            self.perm, self.pos = self.rng.permutation(self.n), 0
        out = self.perm[self.pos:self.pos + self.b]
        self.pos += self.b
        return out


def setup(ctx):
    from nmftpu_torch.serving import Recommender

    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    data = ctx.datagen(cfg["data"]["generator"]).serving(
        cfg["data"], ctx.seed, dev)
    rec = Recommender(data["W"], data["H"], train=data["train"],
                      device=dev, **cfg["serving"])
    state = {"ctx": ctx, "data": data, "rec": rec,
             "seen_counts": np.diff(data["train"].indptr)}
    warm = Batches(data["W"].shape[0], traffic["batch"], ctx.seed + _WARM)
    for _ in range(traffic["warmup_requests"]):
        rec.recommend_certified(warm.next(), k=traffic["k"],
                                exclude_seen=True, fallback="exact")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return state


def _launches():
    from nmftpu_torch.kernels import count_above as CA
    from nmftpu_torch.kernels import mips_reservoir as MR

    return MR.LAUNCHES["reservoir_scan"], CA.LAUNCHES["count_above"]


def window(state, seconds, sl):
    ctx, rec = state["ctx"], state["rec"]
    traffic = ctx.traffic
    k, b = traffic["k"], traffic["batch"]
    batches = Batches(state["data"]["W"].shape[0], b, ctx.seed)
    pick = np.random.default_rng(ctx.seed + _SAMPLE)
    counts = state["seen_counts"]
    lat, uncert, kept = [], [], []
    failed = 0
    slice_rec = None
    if sl is not None:
        sl.start()          # before the clock: the profiler's start-up
        before = _launches()
    t0 = time.perf_counter()
    while True:
        users = batches.next()
        t = time.perf_counter()
        try:
            with torch.profiler.record_function("bench.request"):
                s, i, cert = rec.recommend_certified(
                    users, k=k, exclude_seen=True, fallback="exact")
        except RuntimeError as e:           # a failed request counts
            ctx.log(f"request failed: {e}")
            failed += 1
            lat.append(time.perf_counter() - t)
            uncert.append(0)
            break
        now = time.perf_counter()
        lat.append(now - t)
        bad = np.flatnonzero(~cert)
        uncert.append(len(bad))
        rows = np.unique(np.concatenate([
            bad, [int(np.argmax(counts[users]))],
            pick.choice(b, min(b, traffic["sample_rows_per_request"]),
                        replace=False)]))
        kept.append((users[rows], s[rows].copy(), i[rows].copy()))
        if sl is not None and sl.due(now):
            after = _launches()
            slice_rec = {"requests": len(lat),
                         "uncertified": list(uncert),
                         "launches": [a - c for a, c in zip(after, before)],
                         "wall_s": now - t0, "trace": sl.stop()}
            # reading the trace is not the program's time: the window's
            # clock stands still while it runs
            t0 += time.perf_counter() - now
            now = time.perf_counter()
        if now - t0 >= seconds:
            break
    wall = time.perf_counter() - t0
    if sl is not None and sl.running:
        after = _launches()
        slice_rec = {"requests": len(lat), "uncertified": list(uncert),
                     "launches": [a - c for a, c in zip(after, before)],
                     "wall_s": wall, "trace": sl.stop()}
    ctx.log(f"requests {len(lat)} rows {len(lat) * b} "
            f"p95_ms {yardstick.percentile(lat, 95) * 1e3:.4f}")
    return {"latencies": lat, "uncertified": uncert, "kept": kept,
            "wall_s": wall, "rows": (len(lat) - failed) * b,
            "attempted": len(lat), "failed": failed, "slice": slice_rec}


def end_to_end(rec) -> dict:
    return {"serve_qps": rec["rows"] / rec["wall_s"],
            "serve_p95_ms": yardstick.percentile(rec["latencies"], 95) * 1e3}


def _untraced(rec) -> float:
    """Mean seconds a request outside the traced slice (inside it, when
    the slice held every request)."""
    wall, n = rec["wall_s"], len(rec["latencies"])
    sl = rec["slice"]
    if sl is not None and n > sl["requests"]:
        wall, n = wall - sl["wall_s"], n - sl["requests"]
    return wall / max(n, 1)


def layer_record(state, rec) -> dict:
    ctx = state["ctx"]
    cfg, traffic = ctx.config, ctx.traffic
    W, H = state["data"]["W"], state["data"]["H"]
    table = cfg["serving"].get("table_dtype", "float32")
    return {"b": traffic["batch"], "n": W.shape[0], "m": H.shape[1],
            "r": H.shape[0], "table_dtype": table,
            "slots": cfg["serving"].get("reservoir_slots", 4096),
            "method": cfg["serving"].get("method", "approx"),
            "requests": len(rec["latencies"]),
            "mean_request_s": _untraced(rec),
            "uncertified_rows": sum(rec["uncertified"]),
            "slice": rec["slice"]}


def release(state):
    state.pop("rec", None)
    if state["ctx"].device.type == "cuda":
        torch.cuda.empty_cache()


def answers(state, rec):
    """(users, scores, ids) of the rows judged: every kept row, or at most
    `max_check_rows` of them drawn from the seed."""
    traffic = state["ctx"].traffic
    if not rec["kept"]:
        return None
    users = np.concatenate([u for u, _, _ in rec["kept"]])
    s = np.concatenate([x for _, x, _ in rec["kept"]])
    i = np.concatenate([x for _, _, x in rec["kept"]])
    cap = traffic["max_check_rows"]
    if len(users) > cap:
        keep = np.random.default_rng(state["ctx"].seed + _SAMPLE + 1) \
            .choice(len(users), cap, replace=False)
        users, s, i = users[keep], s[keep], i[keep]
    return users, s, i


def _seen(state, users):
    train, dev = state["data"]["train"], state["ctx"].device
    return [torch.as_tensor(train.indices[train.indptr[u]:train.indptr[u + 1]]
                            .astype(np.int64), device=dev) for u in users]


def control(state, rec, ref):
    """The reference's exact top-k in the control precision, in the
    program's place, for the same sampled users."""
    users, _, _ = answers(state, rec)
    cfg, dev = state["ctx"].config, state["ctx"].device
    table = ref.Table(state["data"]["H"], cfg["serving"].get(
        "table_dtype", "float32"), precision=state["ctx"].control)
    Wq = state["data"]["W"][torch.as_tensor(users, device=dev)]
    s, i = ref.topk(table, Wq, _seen(state, users), state["ctx"].traffic["k"])
    return users, s.float().cpu().numpy(), i.cpu().numpy()


def compare(state, ans, ref) -> dict:
    """The numbers compared, over the judged rows:
    score_gap  largest |program score - reference score of that id|,
               over the row's best reference score;
    rank_gap   largest amount by which a returned id's reference score
               lies below the reference's kth best, over the row's best;
    seen_hits  returned ids that are in the user's seen list;
    bad_rows   rows with an id out of range or repeated, a score not
               finite, or scores not in descending order."""
    if ans is None:
        return {"score_gap": float("inf"), "rank_gap": float("inf"),
                "seen_hits": 1, "bad_rows": 1}
    users, s, i = ans
    ctx = state["ctx"]
    k, dev = ctx.traffic["k"], ctx.device
    H = state["data"]["H"]
    m = H.shape[1]
    bad = ((i < 0) | (i >= m)).any(axis=1) | ~np.isfinite(s).all(axis=1) \
        | (np.diff(s, axis=1) > 0).any(axis=1) \
        | (np.diff(np.sort(i, axis=1), axis=1) == 0).any(axis=1)
    table = ref.Table(H, ctx.config["serving"].get("table_dtype",
                                                   "float32"))
    seen = _seen(state, users)
    Wq = state["data"]["W"][torch.as_tensor(users, device=dev)]
    ids = torch.as_tensor(np.clip(i, 0, m - 1).astype(np.int64), device=dev)
    got = ref.score_ids(table, Wq, ids)
    best_s, _ = ref.topk(table, Wq, seen, k)
    top1 = best_s[:, :1].abs()
    score_gap = ((torch.as_tensor(s, device=dev).double() - got).abs()
                 / top1).max()
    rank_gap = ((best_s[:, k - 1:k] - got).clamp(min=0) / top1).max()
    hits = sum(int(torch.isin(ids[j], seen[j]).sum())
               for j in range(len(users)))
    return {"score_gap": float(score_gap), "rank_gap": float(rank_gap),
            "seen_hits": hits, "bad_rows": int(bad.sum())}

