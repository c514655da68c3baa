"""The port's checkpoint/restart against the reference's.

* Restart continues exactly: 4 steps, save, restore, 4 more steps equal 8
  straight steps bit for bit on the CPU (the reference's
  `test_restart_continues_exactly`, on the port: reduced granite-3-2b,
  batches keyed by step).
* The on-disk format is shared: a float32 train state written by the
  reference's `CheckpointManager` restores into the port, and one written
  by the port restores into the reference's, equal leaf for leaf.
* A corrupted leaf raises on `verify`; rotation keeps the newest `keep`;
  a bfloat16 leaf round-trips.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.common.pytree import named_leaves as jnamed  # noqa: E402
from repro.runtime import train as jtrain  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.common.config import TrainConfig  # noqa: E402
from repro_torch.common.pytree import named_leaves as tnamed  # noqa: E402
from repro_torch.data.synthetic import make_batch_for  # noqa: E402
from repro_torch.optim.adamw import tree_map  # noqa: E402
from repro_torch.runtime import train as ttrain  # noqa: E402


def _train(cfg, steps, state, start=0):
    step_fn = ttrain.build_train_step(
        cfg, TrainConfig(total_steps=20, warmup_steps=2, remat="none"))
    for step in range(start, steps):
        state, metrics = step_fn(state, make_batch_for(cfg, 16, 4, step))
    return state, metrics


def test_restart_continues_exactly(tmp_path):
    cfg = tconfigs.reduced("granite_3_2b")
    init = ttrain.init_train_state(cfg, torch.Generator().manual_seed(0))
    final_a, _ = _train(cfg, 8, init)
    mid, _ = _train(cfg, 4, init)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, mid, blocking=True)
    assert mgr.latest_step() == 4
    restored = mgr.restore(4, tree_map(torch.zeros_like, mid))
    final_b, _ = _train(cfg, 8, restored, start=4)
    assert int(final_b["step"]) == int(final_a["step"]) == 8
    for (na, a), (nb, b) in zip(tnamed(final_a), tnamed(final_b)):
        assert na == nb and a.dtype == b.dtype
        assert torch.equal(a, b), na


def _jax_state():
    cfg = jconfigs.reduced("smollm_360m")
    state, _ = jtrain.init_train_state(cfg, jax.random.PRNGKey(3))
    # non-zero moments and count, so every leaf carries a value
    state["opt"] = jax.tree.map(lambda x: x + 1, state["opt"])
    state["step"] = state["step"] + 7
    return state


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    jstate = _jax_state()
    JManager(str(tmp_path)).save(7, jstate, blocking=True)
    target = ttrain.abstract_train_state(tconfigs.reduced("smollm_360m"))
    got = CheckpointManager(str(tmp_path)).restore(7, target, device="cpu")
    want = dict(jnamed(jstate))
    names = [n for n, _ in tnamed(got)]
    assert names == [n for n, _ in jnamed(jstate)]
    for name, t in tnamed(got):
        w = np.asarray(want[name])
        assert t.device.type == "cpu" and tuple(t.shape) == w.shape
        assert str(t.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_array_equal(t.numpy(), w, err_msg=name)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    cfg = tconfigs.reduced("smollm_360m")
    state = ttrain.init_train_state(cfg, torch.Generator().manual_seed(5))
    state = dict(state, step=state["step"] + 3)
    CheckpointManager(str(tmp_path)).save(3, state, blocking=True)
    jtarget = jax.tree.map(jnp.zeros_like, _jax_state())
    got = JManager(str(tmp_path)).restore(3, jtarget)
    want = dict(tnamed(state))
    for name, leaf in jnamed(got):
        np.testing.assert_array_equal(np.asarray(leaf), want[name].numpy(),
                                      err_msg=name)
        assert str(np.asarray(leaf).dtype) == \
            str(want[name].dtype).split(".")[-1]


def test_corrupted_leaf_raises_on_verify(tmp_path):
    state = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "b": {"c": torch.ones(4, dtype=torch.int32)}}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state, blocking=True)
    path = tmp_path / "step_00000001"
    with open(path / "manifest.json") as f:
        manifest = json.load(f)
    assert [e["name"] for e in manifest["leaves"]] == ["a", "b/c"]
    data = dict(np.load(path / "arrays.npz"))
    data["a1"] = data["a1"] + 1               # the leaf b/c
    np.savez(path / "arrays.npz", **data)
    with pytest.raises(IOError, match="b/c"):
        mgr.restore(1, state)
    bad = mgr.restore(1, state, verify=False)
    assert torch.equal(bad["b"]["c"], state["b"]["c"] + 1)


def test_rotation_async_save_and_bf16(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"w": torch.randn(3, 5).to(torch.bfloat16),
             "n": torch.tensor(3, dtype=torch.int32)}
    for step in (1, 2, 3):
        mgr.save(step, state)               # async: the next save waits
    mgr.wait()
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]
    got = mgr.restore(3, state)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], state["w"]) and int(got["n"]) == 3
    with pytest.raises(KeyError, match="missing"):
        mgr.restore(3, dict(state, extra=torch.zeros(1)))
