"""Faults planted under the timed path, for the tests that show the
check catches them and for the readings that set the limits on the
card. Each is a context manager that patches the program and restores
it on exit; none is reachable from `run.py`. A kind declares the faults
its cells can have in its `FAULTS`, by name:

training (`kinds/train_fits.py` and the kinds built on it):
  unchanged  every step of the ELL engine returns its factors unchanged
  half       the plan is built over half the ratings, each kept rating
             doubled (the mean taken over the rest)
  altered    one entry of each fit's W is moved where the fit returns it
serving (`kinds/serve_closed.py`):
  half       the second half of each batch gets the first half's answers
  altered    one returned id of each request is changed
"""

from __future__ import annotations

import contextlib
import dataclasses


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def planted(kind, fault: str):
    """The fault `fault` of a kind (the object `harness.Cell.kind`
    gives), planted for the length of a `with` block."""
    if fault not in kind.FAULTS:
        raise ValueError(f"no fault {fault!r} in this kind: "
                         f"{sorted(kind.FAULTS)}")
    return kind.FAULTS[fault]()


def unchanged_update():
    """The ELL engine's update, whatever rule its configuration picks,
    returns (W, H) as it got them: `sparse_ops._ell_ops_bundle`, which a
    plan looks up at each run, hands the loop a step that does
    nothing."""
    from nmftpu_torch import sparse_ops as SO

    real = SO._ell_ops_bundle

    def bundle(config):
        return dataclasses.replace(real(config),
                                   update=lambda V, aux, W, H: (W, H))

    return _patched(SO, "_ell_ops_bundle", bundle)


def half_ratings():
    from nmftpu_torch import sparse_ops as SO

    real = SO.prepare_sparse

    def half(V, config, strategy="auto", device=None):
        from nmftpu_torch.sparse import SparseCOO

        coo = V.to_coo()
        keep = slice(0, None, 2)
        V = SparseCOO(row=coo.row[keep], col=coo.col[keep],
                      data=coo.data[keep] * 2, shape=coo.shape)
        return real(V.to_csr(), config, strategy=strategy, device=device)

    return _patched(SO, "prepare_sparse", half)


def altered_w():
    from nmftpu_torch import sparse_ops as SO

    real = SO.SparsePlan.run

    def altered(self, *args, **kw):
        res = real(self, *args, **kw)
        res.W.view(-1)[0] += 0.1 * float(res.W.abs().max())
        return res

    return _patched(SO.SparsePlan, "run", altered)


def _certified(change):
    """`Recommender.recommend_certified` with `change(self, users, s, i)`
    applied to the arrays it returns."""
    from nmftpu_torch.serving import Recommender

    real = Recommender.recommend_certified

    def wrapped(self, users, *args, **kw):
        s, i, cert = real(self, users, *args, **kw)
        change(self, users, s, i)
        return s, i, cert

    return _patched(Recommender, "recommend_certified", wrapped)


def half_batch():
    def change(self, users, s, i):
        h = len(users) // 2
        s[h:2 * h], i[h:2 * h] = s[:h], i[:h]

    return _certified(change)


def altered_id():
    def change(self, users, s, i):
        row = len(users) // 3
        i[row, 0] = (i[row, 0] + 1) % self.n_items

    return _certified(change)
