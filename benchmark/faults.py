"""Faults planted under the timed path, for the tests that show the
check catches them and for the readings that set the limits on the
card. Each is a context manager that patches the program and restores
it on exit; none is reachable from `run.py`.

training:  unchanged  every MU step returns its factors unchanged
           half       the plan is built over half the ratings, each kept
                      rating doubled (the mean taken over the rest)
           altered    one entry of each fit's W is moved where the fit
                      returns it
serving:   half       the second half of each batch gets the first half's
                      answers
           altered    one returned id of each request is changed
"""

from __future__ import annotations

import contextlib

TRAINING = ("unchanged", "half", "altered")
SERVING = ("half", "altered")


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def training(fault: str):
    from nmftpu_torch import sparse_ell as SE
    from nmftpu_torch import sparse_ops as SO
    from nmftpu_torch.kernels import sparse_ell_kernel as SEK

    def unchanged(pair, W, H, *args, **kw):
        return W, H

    if fault == "unchanged":
        with contextlib.ExitStack() as st:
            for mod, name in ((SE, "mu_update_kl_ell"),
                              (SE, "mu_update_frobenius_ell"),
                              (SEK, "mu_update_frobenius_ell_pallas")):
                st.enter_context(_patched(mod, name, unchanged))
            yield
    elif fault == "half":
        real = SO.prepare_sparse

        def half(V, config, strategy="auto", device=None):
            from nmftpu_torch.sparse import SparseCOO

            coo = V.to_coo()
            keep = slice(0, None, 2)
            V = SparseCOO(row=coo.row[keep], col=coo.col[keep],
                          data=coo.data[keep] * 2, shape=coo.shape)
            return real(V.to_csr(), config, strategy=strategy,
                        device=device)

        with _patched(SO, "prepare_sparse", half):
            yield
    elif fault == "altered":
        real = SO.SparsePlan.run

        def altered(self, *args, **kw):
            res = real(self, *args, **kw)
            res.W.view(-1)[0] += 0.1 * float(res.W.abs().max())
            return res

        with _patched(SO.SparsePlan, "run", altered):
            yield
    else:
        raise ValueError(f"no training fault {fault!r}")


@contextlib.contextmanager
def serving(fault: str):
    from nmftpu_torch.serving import Recommender

    real = Recommender.recommend_certified

    def half(self, users, *args, **kw):
        s, i, cert = real(self, users, *args, **kw)
        h = len(users) // 2
        s[h:2 * h], i[h:2 * h] = s[:h], i[:h]
        return s, i, cert

    def altered(self, users, *args, **kw):
        s, i, cert = real(self, users, *args, **kw)
        row = len(users) // 3
        i[row, 0] = (i[row, 0] + 1) % self.n_items
        return s, i, cert

    fn = {"half": half, "altered": altered}.get(fault)
    if fn is None:
        raise ValueError(f"no serving fault {fault!r}")
    with _patched(Recommender, "recommend_certified", fn):
        yield


def planted(kind: str, fault: str):
    return {"train_fits": training, "serve_closed": serving}[kind](fault)

