"""The port's serve launcher (`repro_torch.launch.serve`) against the
reference's (`repro.launch.serve`) on the same argv, the same weights
(the reference's seed-0 init, carried across by `load_numpy_params`) and
the reference's v5e chip and topology pricing the virtual clock and the
admission prior: scenario chat, the classic burst, `--contiguous`,
`--prefix-cache --prefill-chunk` and `--fleet 2` (round-robin and
`--roles`) on fp pools, and the int8 default.

Both packages' `configs.reduced` are pointed at float32 copies of the
reduced configs for the run, so the two engines compute in one dtype
(the launcher has no dtype flag; the fleet and engine tests run float32
the same way). Gates: fp tokens equal request by request, and every
counter of the run's `summary()` equal to rel=1e-9 (the wall-clock
`tok_per_s_wall` left out); on the int8 default each request's lockstep
greedy-token agreement with the reference's int8 run
>= `INT8_TOKEN_AGREEMENT`. The launcher's `ap.error`s for a chunk that
does not divide a bucket, `--prefill-chunk` with `--contiguous` and
`--roles` without `--prefill-chunk` are the reference's."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.common import hw as jhw  # noqa: E402
from repro.core import tiers as jtiers  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.common import hw as thw  # noqa: E402
from repro_torch.core import tiers as ttiers  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.module import load_numpy_params  # noqa: E402
from repro_torch.serving import INT8_TOKEN_AGREEMENT  # noqa: E402

REL = 1e-9


def _ref_topology():
    jt = jtiers.v5e_topology()
    return ttiers.TierTopology(
        tiers=tuple(ttiers.TierSpec(**dataclasses.asdict(t))
                    for t in jt.tiers),
        shared_link_bw=jt.shared_link_bw,
        chips_per_pool=jt.chips_per_pool,
    )


def _ref_chip():
    c = jhw.V5E
    return thw.ChipSpec(name=c.name, peak_flops_bf16=c.peak_flops_bf16,
                        hbm_bytes=c.hbm_bytes, hbm_bw=c.hbm_bw,
                        link_bw=c.ici_link_bw, num_sms=0, smem_per_block=0,
                        l2_bytes=0.0)


@pytest.fixture(scope="module")
def float32_configs():
    """Both packages' reduced configs in float32 for the module."""
    mp = pytest.MonkeyPatch()
    for mod in (jconfigs, tconfigs):
        orig = mod.reduced
        mp.setattr(mod, "reduced",
                   lambda name, _o=orig: dataclasses.replace(
                       _o(name), dtype="float32"))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def weights(float32_configs):
    """The reference engine's seed-0 weights (what `ServingEngine.build`
    draws for `--seed 0`) and their port copy."""
    jc = jconfigs.reduced("smollm_360m")
    jparams, _ = JM.init_model(jc, jax.random.PRNGKey(0))
    return load_numpy_params(jax.tree.map(np.asarray, jparams),
                             device="cpu")


def _run(argv, weights):
    """(reference stats, port stats, reference outputs, port outputs) of
    one argv; the outputs are each request's tokens, by request id."""
    outs = {}
    jstats = _with_outputs(jserve, lambda: jserve.main(argv), outs, "ref")
    tstats = _with_outputs(
        tserve, lambda: tserve.main([*argv, "--device", "cpu"],
                                    params=weights, chip=_ref_chip(),
                                    topo=_ref_topology()), outs, "port")
    return jstats, tstats, outs["ref"], outs["port"]


def _with_outputs(mod, call, outs, key):
    """Run `call` with `mod`'s request factories wrapped so the requests
    it serves are kept; outs[key] = {request_id: output tokens}."""
    kept = []
    names = ("make_scenario", "burst_requests")
    saved = {n: getattr(mod, n) for n in names}

    def wrap(fn):
        def inner(*a, **k):
            reqs = fn(*a, **k)
            kept.extend(reqs)
            return reqs
        return inner

    try:
        for n in names:
            setattr(mod, n, wrap(saved[n]))
        stats = call()
    finally:
        for n in names:
            setattr(mod, n, saved[n])
    outs[key] = {r.request_id: list(map(int, r.output)) for r in kept}
    return stats


def _counters(summary: dict) -> dict:
    return {k: v for k, v in summary.items() if k != "tok_per_s_wall"}


def _assert_summaries_equal(js: dict, ts: dict):
    js, ts = _counters(js), _counters(ts)
    assert set(js) == set(ts)
    for k, v in js.items():
        if isinstance(v, (list, tuple)):
            assert list(ts[k]) == list(v), k
        else:
            assert ts[k] == pytest.approx(v, rel=REL, nan_ok=True), k


CHAT = ["--arch", "smollm-360m", "--reduced", "--scenario", "chat",
        "--requests", "6", "--pool-dtype", "fp"]
BURST = ["--arch", "smollm-360m", "--reduced", "--batch", "3",
         "--prompt-len", "16", "--gen", "6", "--pool-dtype", "fp"]
CASES = {
    "chat": CHAT,
    "burst": BURST,
    "contiguous": [*BURST, "--contiguous"],
    "prefix_chunked": ["--arch", "smollm-360m", "--reduced", "--scenario",
                       "shared_prefix", "--requests", "6", "--pool-dtype",
                       "fp", "--prefix-cache", "--prefill-chunk", "16"],
    "fleet_round_robin": [*CHAT, "--fleet", "2"],
    "fleet_roles": [*CHAT, "--fleet", "2", "--roles", "--prefill-chunk",
                    "16"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_launcher_matches_reference_fp(case, weights):
    jstats, tstats, jout, tout = _run(CASES[case], weights)
    assert jout and tout == jout
    _assert_summaries_equal(jstats.summary(), tstats.summary())


def test_launcher_int8_default_agreement(weights):
    argv = ["--arch", "smollm-360m", "--reduced", "--scenario", "chat",
            "--requests", "6"]
    jstats, tstats, jout, tout = _run(argv, weights)
    assert set(tout) == set(jout)
    for rid, want in jout.items():
        got = tout[rid]
        n = min(len(got), len(want))
        agree = sum(a == b for a, b in zip(got, want)) / max(n, 1)
        assert len(got) == len(want) and agree >= INT8_TOKEN_AGREEMENT, (
            rid, got, want)
    assert tstats.summary()["n_requests"] == jstats.summary()["n_requests"]


@pytest.mark.parametrize("extra,msg", [
    (["--prefill-chunk", "24"], "must divide every prompt bucket"),
    (["--prefill-chunk", "16", "--contiguous"], "needs the paged layout"),
    (["--fleet", "2", "--roles"], "--roles needs --prefill-chunk"),
])
def test_launcher_errors_match_reference(extra, msg, capsys):
    argv = ["--arch", "smollm-360m", "--reduced", "--scenario", "chat",
            *extra]
    for main in (jserve.main, lambda a: tserve.main([*a, "--device",
                                                      "cpu"])):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2
        assert msg in capsys.readouterr().err


def test_launcher_says_compile_counts_do_not_apply(weights, capsys):
    tserve.main([*BURST, "--device", "cpu"], params=weights)
    out = capsys.readouterr().out
    assert "compile counts: does not apply" in out
    assert "compile counts (must stay flat" not in out
