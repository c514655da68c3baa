"""The autograd collectives of `repro_torch.common.parallel` on 2 gloo
ranks (`launch.mesh.run_ranks` once for the module,
`dev_train_torch.collective_grad_rank`), each op's forward and the
gradient of sum(out * c_rank) against the single-process composition in
numpy, over the "model" axis of a (1, 2) mesh (tp: the ranks hold the
same rows, so a value used alike gets the same cotangent on each rank)
and the "data" axis of a (2, 1) mesh (dp: the ranks' losses add):

* psum: forward the sum; backward the identity over tp, the sum of the
  ranks' cotangents over dp;
* enter_region (x replicated, each rank scales it by rank + 1): forward
  the identity, backward the sum of the ranks' partial cotangents;
* all_gather: backward the rank's block of the cotangent, or of the
  ranks' summed cotangents with `reduce_grad` (and `gather_param`, the
  FSDP gather over the fsdp axis);
* all_to_all: backward the inverse exchange, also of a strided
  cotangent (a transpose after the exchange);
* local_slice: backward zeros around the rank's block.

Without grad `psum` still sums in place (the serving path)."""

import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.common import parallel as par  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                       / "scripts"))

import dev_train_torch as dtt  # noqa: E402

N = 2


def _rand(rng, *shape):
    return rng.normal(0, 1, shape).astype(np.float32)


def _cases():
    rng = np.random.default_rng(0)
    same = _rand(rng, 3, 4)
    c_same = _rand(rng, 3, 4)
    cases = {}
    for axis in ("model", "data"):
        xs = [_rand(rng, 3, 4) for _ in range(N)]
        cs = [_rand(rng, 3, 4) for _ in range(N)]
        c = cs if axis == "data" else [c_same] * N
        cases[f"psum/{axis}"] = dict(op="psum", axis=axis, x=xs, c=c)
        cases[f"enter_region/{axis}"] = dict(
            op="enter_region", axis=axis, x=[same] * N, c=cs)
        cases[f"local_slice/{axis}"] = dict(
            op="local_slice", axis=axis, x=[same] * N, dim=1,
            c=[_rand(rng, 3, 2) for _ in range(N)])
        cases[f"all_to_all/{axis}"] = dict(
            op="all_to_all", axis=axis, x=[_rand(rng, N, 5) for _ in range(N)],
            c=[_rand(rng, N, 5) for _ in range(N)])
    cases["all_to_all_strided/model"] = dict(
        op="all_to_all", axis="model", strided=True,
        x=[_rand(rng, N, 3, 5) for _ in range(N)],
        c=[_rand(rng, N, 5, 3) for _ in range(N)])
    g_c = _rand(rng, 3, 8)
    cases["all_gather/model"] = dict(op="all_gather", axis="model", dim=1,
                                     x=[_rand(rng, 3, 4) for _ in range(N)],
                                     c=[g_c] * N)
    cases["all_gather_reduce/data"] = dict(
        op="all_gather", axis="data", dim=0, reduce_grad=True,
        x=[_rand(rng, 2, 4) for _ in range(N)],
        c=[_rand(rng, 4, 4) for _ in range(N)])
    cases["gather_param/data"] = dict(
        op="gather_param", axis="data", dim=1, full=6,
        x=[_rand(rng, 4, 3) for _ in range(N)],
        c=[_rand(rng, 4, 6) for _ in range(N)])
    return cases


CASES = _cases()


def _expected(case):
    """(out, grad) per rank from the single-process composition."""
    x, c, op = case["x"], case["c"], case["op"]
    if op == "psum":
        y = sum(x)
        g = c if case["axis"] == "model" else [sum(c)] * N
        return [y] * N, g
    if op == "enter_region":
        return ([x[r] * (r + 1) for r in range(N)],
                [sum((r + 1) * c[r] for r in range(N))] * N)
    if op == "local_slice":
        d, w = case["dim"], x[0].shape[case["dim"]] // N
        ys, gs = [], []
        for r in range(N):
            ys.append(np.take(x[r], range(r * w, (r + 1) * w), axis=d))
            g = np.zeros_like(x[r])
            idx = [slice(None)] * g.ndim
            idx[d] = slice(r * w, (r + 1) * w)
            g[tuple(idx)] = c[r]
            gs.append(g)
        return ys, gs
    if op == "all_to_all":
        t = (lambda a: np.swapaxes(a, -1, -2)) if case.get("strided") \
            else (lambda a: a)
        ys = [t(np.stack([x[j][r] for j in range(N)])) for r in range(N)]
        gs = [np.stack([t(c[j])[r] for j in range(N)]) for r in range(N)]
        return ys, gs
    d = case["dim"]
    y = np.concatenate(x, axis=d)
    up = sum(c) if op == "gather_param" or case.get("reduce_grad") else c[0]
    w = x[0].shape[d]
    return [y] * N, [np.take(up, range(r * w, (r + 1) * w), axis=d)
                     for r in range(N)]


@pytest.fixture(scope="module")
def ranks():
    got = tmesh.run_ranks(dtt.collective_grad_rank, N,
                          (list(CASES.values()), "cpu"), device="cpu",
                          threads=1, timeout_s=60, wall_s=300)
    return {name: [got[r][i] for r in range(N)]
            for i, name in enumerate(CASES)}


@pytest.mark.parametrize("name", list(CASES))
def test_collective_forward_and_backward(ranks, name):
    ys, gs = _expected(CASES[name])
    for r in range(N):
        np.testing.assert_allclose(ranks[name][r]["y"], ys[r], rtol=1e-6,
                                   atol=1e-6, err_msg=f"{name} rank {r} y")
        np.testing.assert_allclose(ranks[name][r]["grad"], gs[r],
                                   rtol=1e-6, atol=1e-6,
                                   err_msg=f"{name} rank {r} grad")


def test_without_grad_psum_sums_in_place_and_one_rank_is_the_identity():
    """Without a mesh every collective is the identity; without grad
    `psum` returns the tensor it was given (the in-place serving path);
    with grad over size-1 axes the ops give back the same values."""
    x = torch.arange(6.0).reshape(2, 3)
    assert par.psum(x, par.SINGLE, "model") is x
    assert par.all_gather(x, par.SINGLE, "model", 0) is x
    assert par.all_to_all(x, par.SINGLE, "model") is x
    xg = x.clone().requires_grad_()
    y = par.enter_region(xg, par.SINGLE, "model")
    (y * 2).sum().backward()
    assert torch.equal(xg.grad, torch.full_like(x, 2.0))
    assert par.gather_param(x, par.SINGLE, 1, 3) is x
