#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA H100.

Phases (any failure raises and exits non-zero):
  1. device  — the card's name and power limit (nvidia-smi), torch and
               CUDA versions; exit non-zero without a CUDA device.
  2. build   — compile the CUDA kernels of `kernels/csrc/` with nvcc
               (sm_90a, one process per source, in parallel).
  3. kernels — each kernel against its plain PyTorch version on the card:
               the grouped page copy bit for bit (the wrapper and the
               op): write_pages at the old four one-leaf shapes,
               the four-leaf admission (per-page and per-token rows) and
               ids out of range (dropped), page_out / page_in over a pinned
               and a device twin (bursts 1, 7, 64), an unpinned twin
               raising, the fleet's handoff between two pools (bf16 and
               int8, 1 / 8 / 64 pages, the source untouched); flash_mha at the main-path shapes plus head dims {16, 17,
               20, 64, 112, 128, 256}, GQA rep {1, 3, 8}, causal and not,
               kv_offset > 0, Sq {1, 17, 33, 40, 64, 128, 512}, its lse
               against the plain version's (bf16 on the tensor-core
               kernel, checked by name); paged decode over head dims {16,
               20, 64, 112, 128, 256}, pages {16, 64}, GQA rep {1, 3, 8},
               lengths 1 / the split's span edges / a page edge / full /
               parked, garbage table entries past each length, fp (bf16,
               f32) and int8 (per page, per token) pools, each case
               called three times (bit-equal: the ticket reset and the
               span-ordered merge), one launch per op call; the
               three paged chunked-prefill kernels over chunks of 1, 2 and
               8 pages at chunk starts 0 / one page / deep in one batch,
               with garbage table entries above the frontier, their
               written pools equal to the plain version's (head dims up
               to 256, rep {1, 3, 8}; bf16 q on the tensor-core body,
               checked by kernel name at the main shape); flash_decode
               over contiguous caches, f32 and bf16, head dims {16, 20,
               64, 112, 128, 256}, rep {1, 3, 8}, S {64, 256, 260},
               lengths 1 / span edges / S // 2 + 3 / S / S + 1 / S + 7,
               called three times (bit-equal) and once with its
               log-sum-exp (the output bit-equal, the lse against the
               plain version's), and the lse variant at a dp2tp2 rank's
               shape and qwen2.5-32b's decode_32k rank shapes (16x16: B
               8, 2048 positions; a 16384-position block), timed beside
               its bound and SDPA; LBench over nflop
               {0, 1, 2, 5, 16, 32, 128, 1024} x sizes {1, 129, 4096,
               2^20 + 3, 2^28} and an unaligned view (rtol = atol = 2e-5
               up to nflop 128, nflop * 1e-7 above); W8A8 bit for bit
               over the reference test's shapes, a ragged one,
               SmolLM-360M's MLP shapes (M 8 and 1024) and zero operands;
               the device time (torch.profiler, L2 flushed before each
               call) of each kernel, its plain version and a library
               yardstick.
  4. quantify — the analysis path: `scripts/lbench_torch.run()` (paper
               Fig 11: LBench on the card at 2^28 and 2^16 elements with
               its modelled LoI, the modelled saturation sweep, and
               `core.quantify.analyze` IC / injected LoI for every ported
               arch on one H100), the LBench sweep at 2^28 elements out
               to nflop 1024 (GB/s, GFLOP/s, the measured ridge against
               the data sheet's 160, outputs against a float64 chain),
               and one W8A8 call per SmolLM-360M MLP shape (against the
               f32 product): both kernels launched, no plain version.
  5. engine  — SmolLM-360M at published widths (random seeded weights,
               bf16) served by `ServingEngine` on a 16-request chat trace:
               every request finishes, the three bucket-path kernels are
               launched (write_pages once per admission) and no plain
               version runs, the substrate is "physical" with placement
               gap 0 after every drain and the tokens equal the same
               engine's with the substrate off; then the same trace
               with the plain versions on the card
               (`force_backend("reference")`) must agree per request
               (lockstep greedy tokens) >= 0.5, on int8 and on fp pools;
               one more int8 run of 2 requests under torch.profiler prints
               the device's busy share and the host's busiest ops.
  6. substrate — the page streams on SmolLM-360M's int8 pool at 4096
               pages (1.35 GB, pinned host twin): page_out / page_in GB/s
               per burst of 1-4096 pages against the data sheet's 64 GB/s,
               a contiguous copy_ of the same bytes and the plain
               index_select + copy; then the engine phase's trace with
               local_budget_frac=0.25 (pages spill and come back):
               physical, gap 0 after every drain, tokens equal with the
               substrate off, page_out and page_in launched.
  7. prefetch — the paper's two case studies (`prefetch_phase`):
               `scan_with_prefetch` over SmolLM-360M's 32 layers with the
               FFN leaves in pinned host memory (472 MB), copied one
               layer ahead by the page copy (`layer_in`) on a side
               stream: bit-equal to the stack with every leaf on the
               card; a scan whose body copies rows of each layer's
               leaves out to the host, with the main stream spun before
               layer 0 (later copies and bodies queued first), equal to
               the leaves (a copy overwriting a buffer still to be read
               breaks it); one launch a layer, the copy against the
               plain version; the bucket int8 cell at
               local_budget_frac=0.25 with prefetch
               None / demand / stream / ghb: equal tokens, stream's
               demand share below demand's; the stream run's
               `measured_profile` through the rack simulator (fcfs,
               random, aware) and the BFS frontier case study.
     The fleet phase and the substrate phase's engine runs serve
     SmolLM-360M at its widths cut to 8 of its 32 layers, the ssm,
     archs and mamba2 train runs their archs cut too (DEPTH), for the
     script's time limit; each of those phases gates only float32
     agreement, drifts relative to bf16's own or bit-equality, which
     no depth can make a near-tie flip.
  8. fleet   — faults and the fleet on one card (`fleet_phase`): 2-engine
               round-robin fleets against one engine (fp bit-exact, int8
               agreement), chaos_smoke against the fault-free fleet (fp
               bit-exact, retries / restores / migrations / re-prefilled
               tokens > 0, pools drained free), the prefill/decode roles
               against the unified fleet (one handoff launch per
               request), the pool-exhaustion preemption, a pinned freeze
               / thaw and degrade_pool, the handoff timed at 8 and 64
               pages; gap 0 after every drain of every engine.
  9. chunked — the same model with `prefill_chunk=128` and the prefix
               cache on a 16-request shared-prefix trace (prompts 256/512
               behind a 128-token system prompt): int8 runs launch
               paged_prefill_insert_flash_q8, fp runs
               paged_prefill_insert_flash, no plain version runs, and each
               agrees >= 0.5 with its plain run; prefix hits and shared
               pages above 0 with the cache on, and the pages the live
               slots map; then the chunk cell of a per-token
               int8 pool over one 512-token prompt launches
               paged_prefill_flash and agrees with the plain cell.
 10. contiguous — the same model on the contiguous layout (paged=False,
               flash_decode) over 8 chat prompts of 128 tokens, 32 new
               tokens each, against the paged fp engine, the naive
               one-shot loop (`scripts/dev_serve_torch.py`) and its own
               plain-version run: tokens agree >= 0.5 pairwise, and
               whether each pair is bit-exact is printed.
 11. speculative — speculative decoding (k=4) over the same prompts:
               ngram on fp pools, ngram on int8 per-token pools with
               prefill_chunk=128 (paged_prefill_flash inside the engine),
               self-draft on fp (flash_decode on the draft's caches),
               each against the greedy engine of its pool: verify steps,
               acceptance, draft calls, launches, tok/s, agreement.
 12. ssm     — mamba2-780m at published widths (seeded random bf16
               weights) on the engine phase's configuration and chat
               trace (16 of its 48 layers, DEPTH): ssd_scan launches
               once a layer per admission, no plain
               version runs, agreement >= 0.5 with the plain-version run
               in float32 (a random deep stack turns bf16 rounding
               into token flips) and prompt-pass logit drifts within
               bf16's own;
               the paged int8,
               paged fp and contiguous
               engines each equal the naive loop bit for bit on 8 prompts
               of 128 tokens; a float32 prefill of 64 tokens plus 8 decode
               steps against a prefill of 72 (last-token logits within
               2e-3). The kernels phase holds ssd_scan against its plain
               version: the reference test's shapes, mamba2's widths at
               B {1, 8} x S {64, 128, 256}, S = 100, G = 2, D = None and
               an initial state, in float32 and bf16.
 13. archs   — the rest of the catalog at published widths (seeded random
               bf16 weights, depth cut to DEPTH's):
               granite-moe-1b-a400m (MoE,
               32 experts top 8), paligemma-3b (256 patch embeddings
               before the prompt, D 256, 8 heads on 1 KV head) and
               seamless-m4t-large-v2 (24 + 24 layers, cross-attention
               through flash_decode), each on the engine's defaults
               (paged, int8, 16-token pages, 8 slots) over 8 chat
               requests: the kernels launched and no plain version, in
               float32 the kernel and plain runs agree per request >= 0.5
               and the prompt pass's last-token logits within 2e-3 on the
               plain run's routing (the flipped routing decisions
               printed), in bf16 the kernels move them no further than
               bf16 itself; the fp engine equal to the naive loop bit for
               bit; a profiled run that names the kernels; wall tok/s and
               peak device memory. The kernels phase ends with those
               kernels at the archs' shapes (flash_mha at 384 rows of D
               256 and non-causal 128, the paged decode at D 256 / KV 1,
               one paligemma admission's page write, flash_decode at the
               cross shape) against their plain versions in float32 and
               bf16, timed beside their bounds and SDPA.
 14. train   — training (`repro_torch.runtime.train`): flash_mha's CUDA
               backward against its plain version (the chunked backward)
               at smollm-360m's train shapes (B 8, S 256 and 1024, 15/5
               heads), seamless's encoder (non-causal 16/16), paligemma
               (S 384, 8/1, D 256), D 20 at S 100 and a kv_offset, in
               float32 (1e-4 of the largest grad) and bf16 (2e-2), two
               calls bit-equal, no query rows giving zero dk and dv,
               timed beside its bound, the plain version and SDPA's
               backward; SmolLM-360M at published widths, batch 8 x 256,
               12 steps from the seed-0 init: float32 through the kernels
               and the plain versions (losses within 1e-3 at every step;
               from each state of the kernels' run, loss within 1e-3 and
               grad norm within 1e-4 of the plain versions' step; the
               loss falling), bf16 through the kernels (the main path:
               flash_mha and flash_mha_bwd launched, no plain version;
               resume bit-equal to a straight run: phase launch, through
               the launcher); mamba2-780m (16 of its 48 layers, DEPTH;
               batch 4 x 256, 6 steps, float32) through ssd_scan against
               the plain versions from the same states (as smollm), and
               free-running within 1e-3 or ten times the gap of the plain
               run from an init one float32 step away. Step ms, tokens/s
               and peak memory per run.
 15. launch  — the serve launcher (`python -m repro_torch.launch.serve`)
               at SmolLM-360M's published widths: scenario chat, 8
               requests, 8 slots, int8 pool, then `--fleet 2 --roles
               --prefill-chunk 16` on the same trace; tokens equal to an
               engine / fleet built directly from the same configuration,
               the path's kernels launched, no plain version; the train
               launcher (`launch.train.main`, in a process of its own)
               at published widths cut to 2 layers: 4 steps
               straight against 2 and `--resume` 2, the step-4
               checkpoints bit-equal (the launcher's deterministic
               algorithms).
 16. tiering — the tiered train step (`runtime.tiering`): SmolLM-360M,
               batch 8 x 256, hotness at pool_fraction 0.5, 3 steps, the
               pool-tier leaves in pinned host memory moved by the page
               copy (state_in / state_out): bit-equal to the untiered
               step at every step, the copies' launches equal to the
               step's plan; step ms of both runs and the copy ms, beside
               the plain copy_pages and `copy_` on the same leaves.
 17. dryrun  — `python -m repro_torch.launch.dryrun --all` on meta
               tensors, started in a subprocess at nice 10 beside the
               build (it uses the cores the build leaves idle) and waited
               for before the card is timed (every cell ok; each cell's
               dominant term and t_compute_s), and the dry-run's
               flash_mha / flash_mha_bwd / state_in / state_out units of
               the tiering phase's step equal to the launches the card
               made; beside it `--mesh 16x16` on qwen2.5-32b's
               decode_32k and train_4k, mamba2-780m's and
               seamless-m4t-large-v2's decode_32k (rank 0 of 256, ok,
               wire bytes and collectives printed).
 18. mesh    — serving on a mesh (`mesh_phase`): granite-3-2b at published
               widths cut to 8 of its 40 layers on the engine phase's
               bucket cell, 8 chat requests: the three bucket kernels,
               ssd_scan and flash_decode_lse at one dp2tp2 rank's shard
               shapes against their plain versions and timed; a (1, 1)
               mesh on NCCL (one spawned
               rank) bit-equal to the meshless engine (tokens, every pool
               leaf); dp2tp2 as 4 spawned ranks sharing the card over
               gloo: float32 fp tokens of every rank equal to the
               meshless engine's, float32 int8 agreement >= 0.5, data
               replicas bit-equal, each rank's pool half
               the meshless one, placement gap 0 on every rank, the
               kernels launched on every rank; the contiguous layout
               (sequence-sharded caches, flash_decode_lse and the
               cross-rank merge): (1, 1) bf16 bit-equal to the meshless
               contiguous engine, dp2tp2 float32 tokens equal, the
               serve bundle's decode logits within bf16's own drift; on
               the same ranks moe_ep
               at granite-moe-1b-a400m's widths within 1e-4 of moe_dense
               with nothing dropped; then training on the same ranks
               (granite-3-2b cut to 8 layers, batch 8 x 256, two steps):
               (1, 1) bf16 bit-equal to the meshless bundle, dp2tp2
               float32 within 1e-5 of it, bf16 within bf16's own drift of
               a one-process witness of the split, compressed_psum, the
               tiered step, moe_ep's gradients, flash_mha and its
               backward launched on every rank; both flash kernels timed
               at a rank's train shard; then on the same ranks the other
               stacks (ROADMAP A16d): mamba2-780m (4 of 48 layers) and
               seamless-m4t-large-v2 (4 + 4 layers) at published widths,
               4 chat requests of 16 tokens: dp2tp2 float32 paged and
               contiguous tokens equal to the meshless engine's, each
               rank a quarter of the resident state, ssd_scan /
               flash_decode_lse launched on every rank, no plain version,
               bf16 prompt-pass drift within bf16's own, (1, 1) bf16 int8
               bit-equal; ngram speculation (k 4) on granite over
               dp2tp2, float32 tokens equal to the greedy mesh engine's;
               and, last, the other stacks' training (ROADMAP A16e):
               mamba2-780m (2 of 48 layers), paligemma-3b (2 of 18, its
               256 patches) and seamless-m4t-large-v2 (2 + 2) at
               published widths, one step of 4 x 128: dp2tp2 float32
               within 1e-5 of the meshless step, every shard's update
               against it, replicas bit-equal, ssd_scan or flash_mha and
               its backward launched on every rank, bf16 printed; (1, 1)
               mamba2 bf16 bit-equal to the meshless bundle.
The last lines are the kernels' JSON record, the nvidia-smi line and
{"ok": true, "device": {...}}.

    python3 chip_smoke.py                 # one card, every phase
    python3 chip_smoke.py --phases device,build,kernels   # no engine
    python3 chip_smoke.py --phases build,kernels,quantify # the LBench probe
    python3 chip_smoke.py --phases build,contiguous,speculative
    python3 chip_smoke.py --phases build,kernels,ssm      # the SSM slice
    python3 chip_smoke.py --phases device,build,kernels,substrate,engine
    python3 chip_smoke.py --phases device,build,fleet     # faults, the fleet
    python3 chip_smoke.py --phases device,build,kernels,archs  # the archs
    python3 chip_smoke.py --phases device,build,train     # training
    python3 chip_smoke.py --phases device,build,prefetch  # case studies
    python3 chip_smoke.py --phases device,build,launch,tiering,dryrun
    python3 chip_smoke.py --phases device,build,mesh      # the mesh
    python3 chip_smoke.py --phases device,build,launch,mesh  # + launchers
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

# data-sheet peaks of one H100 SXM (the least time a kernel could take is
# the larger of bytes / HBM rate and operations / peak rate for the type)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
F32_TOL = dict(atol=1e-5, rtol=1e-5)
# bf16 outputs: kernel and plain version accumulate in f32 in another
# order and round once to bf16, so they may differ by one bf16 ulp
BF16_TOL = dict(atol=2e-2, rtol=0.0)
# flash_mha's lse: m + log(l) in float32 in both dtypes (bf16 products are
# exact in float32), summed in another order than the plain version
LSE_TOL = dict(atol=1e-4, rtol=1e-5)


# Depth of the models of some later phases (their widths, and so every
# kernel's shapes, stay the published ones): the script grew past its
# time limit on a slow host (1410 s on an H100 at 700 W), so the fleet,
# the substrate's engine runs, ssm, archs and mamba2's training cut their
# stacks to these depths; every gate stays. The chunked and speculative
# phases keep SmolLM-360M's 32 layers: their bf16 int8 agreement gates
# hold kernels against plain versions on random weights, where another
# depth moves which near-ties flip
DEPTH = {"smollm_360m": 8, "mamba2_780m": 16, "granite_moe_1b_a400m": 8,
         "paligemma_3b": 6, "seamless_m4t_large_v2": 8}


def cut_depth(cfg):
    """`cfg` with its decoder (and encoder) depth cut to DEPTH's."""
    from repro_torch import configs

    n = DEPTH[configs.canonical(cfg.name)]
    return dataclasses.replace(
        cfg, num_layers=n,
        **({"num_encoder_layers": n} if cfg.num_encoder_layers else {}))


def demangle(name: str) -> str:
    """A kernel's C++ name with its template arguments, through the CUDA
    toolkit's `cu++filt` (or `c++filt`); the mangled name without one."""
    for tool in ("/usr/local/cuda/bin/cu++filt", "cu++filt", "c++filt"):
        try:
            out = subprocess.run([tool, name], capture_output=True,
                                 text=True, timeout=30).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            continue
        if out:
            return out
    return name


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def smi_clocks() -> str:
    """The card's SM clock, power draw and temperature now (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def profiled_kernels(torch, fn, reps: int, before=None):
    """The device kernels (torch.profiler events, memcpys excluded) of
    `reps` calls of `fn`, `before()` (untraced work, such as an L2 flush)
    and a synchronize ahead of each call, or None when the trace is
    incomplete (printed): a kernel name recorded a number of times that
    is not a multiple of `reps`. Late in a long process torch.profiler
    (2.11) loses the first kernels of a trace, whatever the host does
    before them (`scripts/profiler_drops.py`)."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if before is not None:
                before()
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "memcpy" not in e.name.lower()]
    counts = collections.Counter(short_names([e.name])[0] for e in kern)
    if kern and all(c % reps == 0 for c in counts.values()):
        return kern
    print(f"    (profiler trace incomplete: {dict(counts)} over {reps} "
          "calls)")
    return None


class Timer:
    """Time of one call of a callable over `reps` calls,
    with the 50 MB L2 flushed (a 96 MB device-to-device copy) before
    each call, because the serving path finds its pool cold.

    `device_ms` is the mean over the calls of the kernels' device time
    from a complete `torch.profiler` trace (`profiled_kernels`, the
    flush copies excluded); where the trace is incomplete it takes
    `queued_ms` instead and clears `profiled`. `queued_ms` is the median
    CUDA-events time around a call whose launches were queued behind a
    spin kernel, so that no host time falls between them. `event_ms` is
    the median CUDA-events time around a call, which also counts host
    time between its launches."""

    # the spin ahead of a queued call: 2e7 cycles, 10 ms at 1980 MHz
    SPIN_CYCLES = 20_000_000

    def __init__(self, torch, reps: int = 15):
        self.torch = torch
        self.reps = reps
        self.src = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")
        self.dst = torch.empty_like(self.src)
        self.profiled = True

    def _flush(self):
        self.dst.copy_(self.src)

    def event_ms(self, fn) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(self.reps):
            self._flush()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)

    def queued_ms(self, fn) -> float:
        """For a call that does not synchronize: each call's launches
        are made while the spin runs, and a call whose spin had ended
        before its end event was queued is printed (host time may then
        fall between its launches)."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times, late = [], 0
        for _ in range(self.reps):
            self._flush()
            torch.cuda._sleep(self.SPIN_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            late += torch.cuda.current_stream().query()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        if late:
            print(f"    (queued timing: the spin ended before {late} of "
                  f"{self.reps} calls were queued)")
        return statistics.median(times)

    def device_ms(self, fn) -> float:
        fn()
        kern = profiled_kernels(self.torch, fn, self.reps, self._flush)
        if kern is None:
            self.profiled = False
            return self.queued_ms(fn)
        return sum(e.time_range.elapsed_us() for e in kern) / self.reps / 1e3

    def __call__(self, fn) -> float:
        """Device ms per call (mean); the events ms per call (median,
        host gaps included) is kept in `self.last_event_ms`."""
        self.last_event_ms = self.event_ms(fn)
        return self.device_ms(fn)


def device_kernel_names(torch, fn, tries: int = 3) -> list:
    """Names of the device kernels one call of `fn` launches, one per
    launch (torch.profiler, CPU and CUDA activity as `Timer` profiles).
    A trace with no device activity at all is the profiler missing the
    call (`profiled_kernels`), not a call that launched nothing: the
    call is profiled again, up to `tries` times, and the caller's check
    applies to the first trace that recorded any."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return names


def short_names(names) -> list:
    """Kernel names without namespaces, template arguments or
    parameters."""
    return sorted({re.split(r"[\s:]+", re.split(r"[<(]", n.replace(
        "(anonymous namespace)::", ""), maxsplit=1)[0].strip())[-1]
        for n in names})


def max_err(torch, out, ref, tol) -> tuple[float, bool]:
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    ok = bool((err <= tol["atol"] + tol["rtol"] * ref.abs()).all())
    ok = ok and bool(torch.isfinite(out).all())
    return float(err.max()), ok


# ------------------------------------------------------------- kernels
def kernel_cases(torch, timer):
    """Returns the JSON records of the kernels and page streams (timed at
    the main paths' shapes); raises if any case disagrees."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention import paged as dpaged
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref

    F = torch.nn.functional
    gen = torch.Generator("cuda").manual_seed(0)
    failures = []

    def report(name, case, err, ok, tol):
        flag = "ok  " if ok else "FAIL"
        print(f"  {flag} {name:18s} {case:58s} max_abs_err={err:.3e} "
              f"tol(atol={tol['atol']:g},rtol={tol['rtol']:g})")
        if not ok:
            failures.append(f"{name} {case}")

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    def timed(kernel, plain):
        ms = timer(kernel)
        op_ms = timer.last_event_ms
        return dict(ms=ms, plain_ms=timer(plain), op_ms=op_ms)

    records = []

    # --- A: grouped page copy: write_pages, page_out, page_in, handoff ---
    records += page_copy_cases(torch, timer, gen, randn, report)

    # --- B: flash attention forward --------------------------------------
    print("kernel flash_mha (f32 atol=rtol=1e-5; bf16 atol=2e-2; lse "
          f"atol={LSE_TOL['atol']:g} rtol={LSE_TOL['rtol']:g})")
    flash_cases = [
        # (B, Sq, Skv, H, KV, D, causal, kv_offset, dtype)
        (1, 128, 128, 15, 5, 64, True, 0, torch.bfloat16),   # main path
        (1, 64, 64, 15, 5, 64, True, 0, torch.bfloat16),     # main path
        (1, 128, 128, 15, 5, 64, True, 0, torch.float32),
        (2, 1, 1, 3, 1, 20, True, 0, torch.float32),
        (2, 17, 17, 3, 1, 20, True, 0, torch.float32),
        (2, 17, 40, 4, 4, 16, False, 0, torch.float32),
        (1, 128, 160, 6, 2, 128, True, 32, torch.float32),
        (1, 512, 512, 6, 2, 128, True, 0, torch.bfloat16),
        (1, 512, 512, 4, 4, 64, False, 0, torch.float32),
        (2, 17, 49, 3, 3, 16, True, 32, torch.bfloat16),
        (1, 128, 128, 3, 1, 20, True, 0, torch.bfloat16),
        # head dims 112 / 256 and GQA rep 8 (kimi, paligemma)
        (1, 128, 128, 24, 3, 112, True, 0, torch.bfloat16),
        (1, 128, 128, 8, 1, 256, True, 0, torch.bfloat16),
        (2, 17, 49, 16, 2, 256, True, 32, torch.bfloat16),
        (1, 64, 64, 16, 2, 112, False, 0, torch.bfloat16),
        (1, 512, 512, 16, 2, 64, True, 0, torch.bfloat16),
        (2, 1, 1, 8, 1, 256, True, 0, torch.bfloat16),
        (1, 33, 33, 6, 2, 17, True, 0, torch.bfloat16),      # odd D
        (1, 64, 64, 8, 1, 112, True, 0, torch.float32),
        (1, 40, 72, 16, 2, 256, True, 32, torch.float32),
    ]
    main_b = None
    for (B, Sq, Skv, H, KV_, D_, causal, off, dt) in flash_cases:
        q = randn(B, Sq, H, D_, dtype=dt)
        k = randn(B, Skv, KV_, D_, dtype=dt)
        v = randn(B, Skv, KV_, D_, dtype=dt, scale=0.5)
        out, lse = fa.flash_mha_cuda(q, k, v, causal=causal, kv_offset=off)
        ref, ref_lse = fref.mha(q, k, v, causal=causal, kv_offset=off,
                                return_lse=True)
        tol = F32_TOL if dt == torch.float32 else BF16_TOL
        err, ok = max_err(torch, out, ref, tol)
        lse_err, lse_ok = max_err(torch, lse, ref_lse, LSE_TOL)
        report("flash_mha", f"B={B} Sq={Sq} Skv={Skv} H={H} KV={KV_} "
               f"D={D_} causal={causal} off={off} {str(dt)[6:]} lse "
               f"{lse_err:.1e}", err, ok and lse_ok, tol)
        if main_b is None:
            main_b = (q, k, v, err)
    q, k, v, err_b = main_b
    B, Sq, H, D_ = q.shape
    Skv, KV_ = k.shape[1], k.shape[2]
    # bf16 must run the tensor-core body, not the float32 FMA one
    names = device_kernel_names(torch, lambda: fops.mha(q, k, v,
                                                        impl="cuda"))
    report("flash_mha", "main shape on the tensor-core kernel: "
           + ", ".join(short_names(names)), 0.0,
           any("flash_mma_kernel" in n for n in names)
           and not any("flash_fma_kernel" in n for n in names),
           dict(atol=0, rtol=0))
    # the bound reads the formula the dry-run's flash_mha unit reads
    ops_b, bytes_b = fops.mha_cost(q.shape, k.shape, causal=True,
                                   itemsize=q.element_size())
    t_bytes, t_ops = bytes_b / HBM_BYTES_PER_S, ops_b / PEAK_OPS["bfloat16"]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    try:
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       enable_gqa=True)
        lib_b = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
    except TypeError:          # torch without enable_gqa
        lib_b = None
    records.append(dict(
        name="flash_mha", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:75",
        max_abs_err=err_b,
        **timed(lambda: fops.mha(q, k, v, impl="cuda"),
                lambda: fops.mha(q, k, v, impl="reference")),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=lib_b,
        shape=f"bf16 causal B={B} Sq=Skv={Sq} H={H} KV={KV_} D={D_}",
    ))

    # --- C: paged flash decode -------------------------------------------
    print("kernel paged_flash_decode (f32 atol=rtol=1e-5; bf16 atol=2e-2)")

    def decode_inputs(B, H, KV_, D_, page_, n_pages, pool, qdt, lengths):
        P_ = B * n_pages
        q = randn(B, H, D_, dtype=qdt)
        bt = torch.stack([torch.randperm(P_, generator=gen, device="cuda")
                          [:n_pages] for _ in range(B)]).to(torch.int32)
        shape = (P_, page_, KV_, D_)
        if pool in ("bf16", "f32"):
            dt = torch.bfloat16 if pool == "bf16" else torch.float32
            return (q, randn(*shape, dtype=dt), randn(*shape, dtype=dt,
                                                      scale=0.5),
                    bt, lengths, {})
        kp = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                           dtype=torch.int8)
        sz_shape = (P_, KV_) if pool == "int8/page" else (P_, page_, KV_)

        def sz():
            scale = torch.rand(sz_shape, generator=gen, device="cuda")
            zero = torch.rand(sz_shape, generator=gen, device="cuda") - 0.5
            return torch.stack([0.005 + 0.015 * scale, zero], -1)

        return q, kp, vp, bt, lengths, dict(k_sz=sz(), v_sz=sz())

    main_lengths = torch.tensor([70, 100, 129, 160, 200, 240, 256, 257],
                                dtype=torch.int32, device="cuda")
    cases = [(8, 15, 5, 64, 16, 16, "int8/page", torch.bfloat16,
              main_lengths)]                                  # main path

    def qdtype(pool, D_):
        return torch.bfloat16 if pool == "bf16" else (
            torch.float32 if pool == "f32" else
            (torch.bfloat16 if D_ == 64 else torch.float32))

    for D_ in (16, 20, 64, 128):
        for page_ in (16, 64):
            for rep in (1, 3):
                for pool in ("bf16", "f32", "int8/page", "int8/token"):
                    n_pages = 3
                    full = n_pages * page_
                    lens = torch.tensor([1, page_, full, full + 7],
                                        dtype=torch.int32, device="cuda")
                    cases.append((4, 2 * rep, 2, D_, page_, n_pages, pool,
                                  qdtype(pool, D_), lens))
    # length 0 (the mean of physical page 0's V rows, the slot's own
    # table entries all garbage), the split's span edges (1, span - 1,
    # span, span + 1), a page edge, the capacity and a parked row, over
    # three spans of keys, at every head dim up to 256 and GQA rep up to 8
    for D_ in (16, 20, 64, 112, 128, 256):
        span = dpaged.default_span(D_)
        for page_ in (16, 64):
            for rep in (1, 3, 8):
                for pool in ("bf16", "f32", "int8/page", "int8/token"):
                    n_pages = -(-(2 * span + 16) // page_)
                    full = n_pages * page_
                    lens = torch.tensor([0, 1, span - 1, span, span + 1,
                                         page_, 2 * span + 1, full,
                                         full + 7],
                                        dtype=torch.int32, device="cuda")
                    cases.append((9, 2 * rep, 2, D_, page_, n_pages, pool,
                                  qdtype(pool, D_), lens))
    main_c = None
    n_dec, worst_c = 0, {"f32": 0.0, "bf16": 0.0}
    for (B, H, KV_, D_, page_, n_pages, pool, qdt, lens) in cases:
        q, kp, vp, bt, lens, sz = decode_inputs(B, H, KV_, D_, page_,
                                                n_pages, pool, qdt, lens)
        if main_c is not None:
            # garbage table entries past each row's length: the kernel
            # must not dereference them (the plain version clamps them)
            dead = (torch.arange(n_pages, device="cuda")[None, :] * page_
                    >= lens[:, None])
            bt = torch.where(dead, kp.shape[0] + 1000, bt).to(torch.int32)
        out = dops.paged_decode_mha(q, kp, vp, bt, lens, impl="cuda", **sz)
        ref = dops.paged_decode_mha(q, kp, vp, bt, lens, impl="reference",
                                    **sz)
        exact = qdt == torch.float32 and pool != "bf16"
        tol = F32_TOL if exact else BF16_TOL
        err, ok = max_err(torch, out, ref, tol)
        # the ticket reset and the span-ordered merge: later calls equal
        # the first bit for bit
        same = all(torch.equal(out, dops.paged_decode_mha(
            q, kp, vp, bt, lens, impl="cuda", **sz)) for _ in range(2))
        n_dec += 1
        worst_c["f32" if exact else "bf16"] = max(
            worst_c["f32" if exact else "bf16"], err)
        if main_c is None or not (ok and same):
            report("paged_flash_decode",
                   f"B={B} H={H} KV={KV_} D={D_} page={page_} pool={pool} "
                   f"q={str(qdt)[6:]} len={lens.tolist()}"[:58]
                   + ("" if same else " REPEAT DIFFERS"), err, ok and same,
                   tol)
        if main_c is None:
            main_c = (q, kp, vp, bt, lens, sz, err)
    print(f"  paged_flash_decode: {n_dec} cases, each called three times "
          f"(bit-equal); max_abs_err f32 {worst_c['f32']:.3e}, bf16 "
          f"{worst_c['bf16']:.3e}")
    q, kp, vp, bt, lens, sz, err_c = main_c
    # one launch of the split kernel per op call, the merge included
    names = device_kernel_names(torch, lambda: dops.paged_decode_mha(
        q, kp, vp, bt, lens, impl="cuda", **sz))
    n_split = sum("decode_split_kernel" in n for n in names)
    report("paged_flash_decode", f"main shape: {n_split} launch of the "
           "split kernel per call; " + ", ".join(short_names(names)), 0.0,
           n_split == 1, dict(atol=0, rtol=0))
    B, H, D_ = q.shape
    page_, KV_ = kp.shape[1], kp.shape[2]
    n_pages = bt.shape[1]
    keys = lens.clamp(max=n_pages * page_)
    n_keys = int(keys.sum())
    n_page_reads = int((-(-keys // page_)).sum())
    bytes_c = (2 * n_keys * KV_ * D_ * kp.element_size()     # K and V
               + 2 * n_page_reads * KV_ * 2 * 4               # (scale, zero)
               + 2 * q.numel() * q.element_size()             # q and out
               + n_page_reads * 4 + B * 4)                    # table, lens
    ops_c = 4 * D_ * H * n_keys
    t_bytes, t_ops = bytes_c / HBM_BYTES_PER_S, ops_c / PEAK_OPS["bfloat16"]
    # library yardstick: SDPA over the K/V gathered and dequantized to bf16
    # beforehand (the gather is excluded from its time), lengths as a mask
    kd = dref.gather_pages_q8(kp, sz["k_sz"], bt).to(torch.bfloat16)
    vd = dref.gather_pages_q8(vp, sz["v_sz"], bt).to(torch.bfloat16)
    lib_c = sdpa_decode_ms(torch, timer, q, kd, vd, lens)
    records.append(dict(
        name="paged_flash_decode", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_decode.cu",
        replaces="src/repro/kernels/decode_attention/paged.py:106",
        max_abs_err=err_c,
        **timed(lambda: dops.paged_decode_mha(q, kp, vp, bt, lens,
                                              impl="cuda", **sz),
                lambda: dops.paged_decode_mha(q, kp, vp, bt, lens,
                                              impl="reference", **sz)),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=lib_c,
        shape=(f"int8/page pool B={B} H={H} KV={KV_} D={D_} page={page_} "
               f"n_pages={n_pages} lengths={lens.tolist()}; library = "
               "SDPA, gather excluded"),
    ))
    records += flash_decode_cases(torch, timer, randn, report, timed)
    records += prefill_kernel_cases(torch, timer, gen, randn, report,
                                    timed)
    records.append(lbench_cases(torch, timer, gen, report, timed))
    records.append(w8a8_cases(torch, timer, randn, report, timed))
    records.append(ssd_cases(torch, timer, gen, report, timed))
    shapes = arch_shape_cases(torch, timer, gen, randn, report)
    long_slots = long_slot_cases(torch, timer, gen, randn, report)
    if failures:
        raise AssertionError(f"{len(failures)} kernel cases disagree: "
                             f"{failures}")
    for r in records:
        print(f"  time {r['name']:18s} kernel {r['ms']:.4f} ms (op with "
              f"host gaps {r.pop('op_ms'):.4f} ms)  plain "
              f"{r['plain_ms']:.4f} ms  library {r['library_ms']} ms  "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
              f"[{r['shape']}]")
    print("  device times from torch.profiler" + (
        "" if timer.profiled else
        " (CUDA events behind a queued spin where a trace was incomplete)")
        + ", L2 flushed before each call")
    print("arch shape records " + json.dumps(shapes))
    print("long slot records " + json.dumps(long_slots))
    return records


def page_copy_cases(torch, timer, gen, randn, report):
    """The grouped page copy (`csrc/page_io.cu`) against its plain version,
    bit for bit, through the wrapper and the op: write_pages through
    the one-segment path at the old four shapes, the grouped four-leaf
    admission (k, k_sz, v, v_sz) with per-page and per-token rows, and
    with ids out of range (dropped); page_out / page_in over a pinned
    host twin (and a device twin, as emulated mode runs it); the fleet's
    handoff between two pools (both id vectors; bf16 and int8 payloads).
    Returns the records of write_pages (the grouped admission), page_out,
    page_in and the handoff at the main path's shapes."""
    from repro_torch.kernels.page_io import ops as pops
    from repro_torch.kernels.page_io import page_io as pio

    exact = dict(atol=0, rtol=0)
    nb, P, page, KV, D = 32, 128, 16, 5, 64      # SmolLM-360M pool

    def leaf(n, shape, dt):
        if dt == torch.int8:
            return torch.randint(-127, 128, (nb, n, *shape), generator=gen,
                                 device="cuda", dtype=torch.int8)
        return randn(nb, n, *shape, dtype=dt)

    def leaves(n, sz_shape):
        return [leaf(n, s, dt) for s, dt in
                (((page, KV, D), torch.int8), (sz_shape, torch.float32)) * 2]

    def M(t):
        return t[0, 0].numel() * t.element_size()

    def check_write(label, pools, tiles, phys):
        want = [p.clone() for p in pools]
        pops.write_pages_group(want, tiles, phys, impl="reference")
        outs = {"wrapper": [p.clone() for p in pools]}
        pio.write_pages_cuda(outs["wrapper"], tiles, phys)
        got = [p.clone() for p in pools]
        if len(pools) == 1:           # the op's one-segment path
            pops.write_pages(got[0], tiles[0], phys, impl="cuda")
        else:
            pops.write_pages_group(got, tiles, phys, impl="cuda")
        outs["op"] = got
        torch.cuda.synchronize()
        for via, got in outs.items():
            ok = all(torch.equal(a, b) for a, b in zip(got, want))
            report("write_pages", f"{label} [{via}]",
                   0.0 if ok else float("inf"), ok, exact)

    print("kernel write_pages (exact; the wrapper and the op)")
    for kind, n_wp in (("int8 payload", 8), ("int8 payload", 4),
                       ("f32 sz rows", 8), ("bf16 fp payload", 8)):
        shape, dt = {"int8 payload": ((page, KV, D), torch.int8),
                     "f32 sz rows": ((KV, 2), torch.float32),
                     "bf16 fp payload": ((page, KV, D), torch.bfloat16)}[kind]
        pool, tiles = leaf(P, shape, dt), leaf(n_wp, shape, dt)
        phys = torch.randperm(P, generator=gen, device="cuda")[:n_wp].to(
            torch.int32)
        check_write(f"{kind} nb={nb} P={P} n_wp={n_wp} M={M(tiles)}B",
                    [pool], [tiles], phys)
    n_wp = 8
    phys = torch.randperm(P, generator=gen, device="cuda")[:n_wp].to(
        torch.int32)
    for gran, sz_shape in (("page", (KV, 2)), ("token", (page, KV, 2))):
        pools, tiles = leaves(P, sz_shape), leaves(n_wp, sz_shape)
        check_write(f"grouped k,k_sz,v,v_sz sz={gran} ({M(tiles[1])}B rows)"
                    f" n_wp={n_wp}", pools, tiles, phys)
        if gran == "page":
            main = (pools, tiles)
    bad = phys.clone()
    bad[1], bad[5] = P, -1
    check_write("grouped, ids P and -1 dropped", *main, bad)

    # the main shape: one admission's grouped insert
    pools, tiles = main
    work = [p.clone() for p in pools]
    phys64 = phys.long()
    moved = sum(2 * t.numel() * t.element_size() for t in tiles)

    def four_calls():
        for p, t in zip(work, tiles):
            pio.write_pages_cuda([p], [t], phys)

    four_ms = timer(four_calls)
    four_event_ms = timer.last_event_ms
    rec = dict(
        name="write_pages", route="cuda",
        source="src/repro_torch/kernels/csrc/page_io.cu",
        replaces="src/repro/kernels/page_io/page_io.py:33",
        max_abs_err=0.0,
        ms=timer(lambda: pops.write_pages_group(work, tiles, phys,
                                                impl="cuda")),
        op_ms=timer.last_event_ms,
        plain_ms=timer(lambda: pops.write_pages_group(
            work, tiles, phys, impl="reference")),
        bound_ms=(moved + phys.numel() * 4) / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
        library_ms=timer(lambda: [p.index_copy_(1, phys64, t)
                                  for p, t in zip(work, tiles)]),
        four_call_ms=four_ms, four_call_op_ms=four_event_ms,
        shape=f"k,k_sz,v,v_sz of int8 pool ({nb},{P},{page},{KV},{D}) "
              f"n_wp={n_wp}",
    )
    print(f"  write_pages grouped admission: {rec['ms'] * 1e3:.2f} us "
          f"against the byte bound {rec['bound_ms'] * 1e3:.2f} us; four one-leaf calls "
          f"{four_ms * 1e3:.2f} us device, {four_event_ms * 1e3:.2f} us "
          f"events; index_copy_ x4 {rec['library_ms'] * 1e3:.2f} us")
    records = [rec]

    # --- page_out / page_in over the twin --------------------------------
    print("kernel page_out / page_in (exact; pinned host twin, device twin)")
    for twin_dev in ("pinned", "cuda"):
        for burst in (1, 7, 64):
            pools = leaves(P, (KV, 2))
            ids = torch.randperm(P, generator=gen, device="cuda")[:burst].to(
                torch.int32)
            twins = [torch.zeros(p.shape, dtype=p.dtype, pin_memory=True)
                     if twin_dev == "pinned" else torch.zeros_like(p)
                     for p in pools]
            want = [t.clone() for t in twins]
            pops.copy_pages(want, ids, pools, ids, name="page_out",
                            impl="reference")
            pops.copy_pages(twins, ids, pools, ids, name="page_out")
            scratch = [torch.empty((nb, burst, *p.shape[2:]), dtype=p.dtype,
                                   device="cuda") for p in pools]
            pops.copy_pages(scratch, None, twins, ids, name="page_in")
            torch.cuda.synchronize()
            ok_out = all(torch.equal(a, b) for a, b in zip(twins, want))
            ok_in = all(torch.equal(s_, p[:, ids.long()])
                        for s_, p in zip(scratch, pools))
            report("page_out", f"{twin_dev} twin, 4 leaves, {burst} pages",
                   0.0 if ok_out else float("inf"), ok_out, exact)
            report("page_in", f"{twin_dev} twin, 4 leaves, {burst} pages "
                   "== what page_out wrote", 0.0 if ok_in else float("inf"),
                   ok_in, exact)
    try:
        pops.copy_pages(torch.zeros(pools[0].shape, dtype=torch.int8),
                        ids, pools[0], ids, name="page_out")
        ok = False
    except ValueError:
        ok = True
    report("page_out", "an unpinned host twin raises", 0.0 if ok else
           float("inf"), ok, exact)

    # the main path's shape: the engine's drains move a few pages of the
    # four leaves at a time; time a burst of 8 over the pinned twin
    burst = 8
    pools = leaves(P, (KV, 2))
    ids = torch.randperm(P, generator=gen, device="cuda")[:burst].to(
        torch.int32)
    twins = [torch.zeros(p.shape, dtype=p.dtype, pin_memory=True)
             for p in pools]
    scratch = [torch.empty((nb, burst, *p.shape[2:]), dtype=p.dtype,
                           device="cuda") for p in pools]
    n_bytes = sum(burst * p[:, 0].numel() * p.element_size() for p in pools)
    host = torch.empty(n_bytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(n_bytes, dtype=torch.uint8, device="cuda")
    # the least time: the page bytes cross PCIe once (64 GB/s a direction,
    # `common/hw.py` H100_HOST) and device memory once
    bound = max(n_bytes / HBM_BYTES_PER_S, n_bytes / 64e9) * 1e3
    for name, line, kernel, plain, lib in (
            ("page_out", 88,
             lambda: pops.copy_pages(twins, ids, pools, ids, name="page_out"),
             lambda: pops.copy_pages(twins, ids, pools, ids, name="page_out",
                                     impl="reference"),
             lambda: host.copy_(dev, non_blocking=True)),
            ("page_in", 92,
             lambda: pops.copy_pages(scratch, None, twins, ids,
                                     name="page_in"),
             lambda: pops.copy_pages(scratch, None, twins, ids,
                                     name="page_in", impl="reference"),
             lambda: dev.copy_(host, non_blocking=True))):
        ms = timer(kernel)
        records.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/page_io.cu",
            replaces=f"src/repro/serving/substrate/tier_substrate.py:{line}",
            max_abs_err=0.0, ms=ms, op_ms=timer.last_event_ms,
            # the plain version runs on the host too (index_copy_ into the
            # twin) and the copy_ yardstick is a memcpy, not a kernel: both
            # timed with CUDA events around the call
            plain_ms=timer.event_ms(plain), bound_ms=bound, bound_by="bytes",
            library_ms=timer.event_ms(lib),
            shape=f"4 leaves of int8 pool ({nb},{P},{page},{KV},{D}), "
                  f"{burst} pages, pinned twin"))

    # --- the fleet's handoff: pool to pool, both id vectors -------------
    print("kernel handoff (exact; the four leaves of one pool onto "
          "another's, bf16 and int8 payloads)")
    for dt in (torch.bfloat16, torch.int8):
        for burst in (1, 8, 64):
            src, dst, s_ids, d_ids = handoff_inputs(torch, gen, burst, dt)
            src0 = [t.clone() for t in src]
            want = [t.clone() for t in dst]
            pops.copy_pages(want, d_ids, src, s_ids, name="handoff",
                            impl="reference")
            pops.copy_pages(dst, d_ids, src, s_ids, name="handoff")
            torch.cuda.synchronize()
            ok = (all(torch.equal(a, b) for a, b in zip(dst, want))
                  and all(torch.equal(a, b) for a, b in zip(src, src0)))
            report("handoff", f"{str(dt)[6:]} pools, 4 leaves, {burst} "
                   "pages, source untouched", 0.0 if ok else float("inf"),
                   ok, exact)
    t = handoff_times(torch, timer, gen, 8)
    records.append(dict(
        name="handoff", route="cuda",
        source="src/repro_torch/kernels/csrc/page_io.cu",
        replaces="src/repro/serving/fleet/roles.py:94",
        max_abs_err=0.0, ms=t["ms"], op_ms=t["op_ms"],
        plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by="bytes",
        library_ms=None,
        shape=f"4 leaves of int8 pool ({nb},{P},{page},{KV},{D}) onto "
              f"another, 8 pages"))
    return records


def handoff_inputs(torch, gen, n_pages, dtype=None):
    """Two SmolLM-360M pools of 128 pages (k, k_sz, v, v_sz; payload in
    `dtype`, int8 by default, with float32 (scale, zero) rows) and
    distinct random source and destination ids of `n_pages` pages."""
    nb, P, page, KV, D = 32, 128, 16, 5, 64
    dtype = dtype or torch.int8

    def leaf(shape, dt):
        if dt == torch.int8:
            return torch.randint(-127, 128, (nb, P, *shape), generator=gen,
                                 device="cuda", dtype=torch.int8)
        return torch.randn((nb, P, *shape), generator=gen,
                           device="cuda").to(dt)

    shapes = (((page, KV, D), dtype), ((KV, 2), torch.float32)) * 2
    src = [leaf(sh, dt) for sh, dt in shapes]
    dst = [leaf(sh, dt) for sh, dt in shapes]

    def ids():
        return torch.randperm(P, generator=gen, device="cuda")[
            :n_pages].to(torch.int32)

    return src, dst, ids(), ids()


def handoff_times(torch, timer, gen, n_pages) -> dict:
    """The handoff stream at `n_pages` pages of the int8 pool: the
    kernel's device ms, its CUDA-events ms, the plain version's device ms
    and the bound (each page and id read once, each page written once,
    at the HBM rate)."""
    from repro_torch.kernels.page_io import ops as pops

    src, dst, s_ids, d_ids = handoff_inputs(torch, gen, n_pages)
    n_bytes = sum(n_pages * t[:, 0].numel() * t.element_size()
                  for t in src)
    ms = timer(lambda: pops.copy_pages(dst, d_ids, src, s_ids,
                                       name="handoff"))
    op_ms = timer.last_event_ms
    plain_ms = timer(lambda: pops.copy_pages(dst, d_ids, src, s_ids,
                                             name="handoff",
                                             impl="reference"))
    return dict(ms=ms, op_ms=op_ms, plain_ms=plain_ms, bytes=n_bytes,
                bound_ms=(2 * n_bytes + 2 * 4 * n_pages)
                / HBM_BYTES_PER_S * 1e3)


def arch_shape_cases(torch, timer, gen, randn, report) -> list:
    """The kernels at the shapes the archs phase gives them and no earlier
    path did: flash_mha causal over paligemma-3b's 256-patch prefix plus
    a 128-token prompt (B 1, S 384, 8 heads on 1 KV head, D 256) and
    non-causal at seamless-m4t's encoder and cross-attention (Sq = Skv =
    128, 16 / 16 heads, D 64); paged_flash_decode over paligemma's int8
    pool (B 8, 8 / 1 heads, D 256); the grouped write_pages of one
    paligemma admission (k, k_sz, v, v_sz over 18 layers, KV 1, D 256,
    384 rows); flash_decode of seamless's decode-time cross-attention (B 8,
    S 128, 16 / 16 heads, D 64, every length 128). Each is held against
    its plain version in float32 and in bf16 (the write bit for bit in
    both payloads) and timed in bf16 beside its bound and the library
    call that computes the same function. Returns the timing records."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.page_io import ops as pops

    F = torch.nn.functional
    exact = dict(atol=0, rtol=0)
    records = []

    def bound(bytes_, ops_, dtype="bfloat16"):
        t_b, t_o = bytes_ / HBM_BYTES_PER_S, ops_ / PEAK_OPS[dtype]
        return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"

    def record(name, case, kernel, plain, lib, bytes_, ops_, err16):
        b_ms, b_by = bound(bytes_, ops_)
        rec = dict(name=name, case=case, ms=timer(kernel),
                   plain_ms=timer(plain), bound_ms=b_ms, bound_by=b_by,
                   library_ms=lib() if lib is not None else None,
                   max_abs_err_bf16=err16)
        print(f"  arch shape {name:18s} {case}: kernel {rec['ms']:.4f} ms "
              f"plain {rec['plain_ms']:.4f} ms library {rec['library_ms']} "
              f"ms bound {b_ms:.4f} ms ({b_by})")
        records.append(rec)

    def sdpa(q, k, v, causal):
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        try:
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                           enable_gqa=True)
        except TypeError:          # torch without enable_gqa
            return None
        return timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))

    print("arch shapes (f32 atol=rtol=1e-5; bf16 atol=2e-2; write_pages "
          "exact)")
    # --- flash_mha: paligemma's prefix + prompt, seamless's non-causal ---
    for (B, S, H, KV, D, causal, arch) in (
            (1, 384, 8, 1, 256, True, "paligemma prefix+prompt"),
            (1, 128, 16, 16, 64, False, "seamless encoder/cross")):
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            q = randn(B, S, H, D, dtype=dt)
            k = randn(B, S, KV, D, dtype=dt)
            v = randn(B, S, KV, D, dtype=dt, scale=0.5)
            out = fops.mha(q, k, v, causal=causal, impl="cuda")
            ref = fops.mha(q, k, v, causal=causal, impl="reference")
            tol = F32_TOL if dt == torch.float32 else BF16_TOL
            errs[dt], ok = max_err(torch, out, ref, tol)
            report("flash_mha", f"{arch}: B={B} S={S} H={H} KV={KV} D={D} "
                   f"causal={causal} {str(dt)[6:]}", errs[dt], ok, tol)
        ops_, bytes_ = fops.mha_cost(q.shape, k.shape, causal=causal,
                                     itemsize=q.element_size())
        record("flash_mha", f"{arch} bf16 B={B} S={S} H={H} KV={KV} D={D} "
               f"causal={causal}",
               lambda: fops.mha(q, k, v, causal=causal, impl="cuda"),
               lambda: fops.mha(q, k, v, causal=causal, impl="reference"),
               lambda: sdpa(q, k, v, causal), bytes_, ops_,
               errs[torch.bfloat16])

    # --- paged_flash_decode: paligemma's int8 pool, D 256, rep 8 ---------
    B, H, KV, D, page, n_pages = 8, 8, 1, 256, 16, 26
    P = B * n_pages
    lens = torch.tensor([320, 330, 340, 350, 360, 370, 380, 400],
                        dtype=torch.int32, device="cuda")
    bt = torch.stack([torch.randperm(P, generator=gen, device="cuda")
                      [:n_pages] for _ in range(B)]).to(torch.int32)
    kp, vp = (torch.randint(-127, 128, (P, page, KV, D), generator=gen,
                            device="cuda", dtype=torch.int8)
              for _ in range(2))

    def sz():
        scale = torch.rand((P, KV), generator=gen, device="cuda")
        zero = torch.rand((P, KV), generator=gen, device="cuda") - 0.5
        return torch.stack([0.005 + 0.015 * scale, zero], -1)

    szs = dict(k_sz=sz(), v_sz=sz())
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        q = randn(B, H, D, dtype=dt)
        out = dops.paged_decode_mha(q, kp, vp, bt, lens, impl="cuda", **szs)
        ref = dops.paged_decode_mha(q, kp, vp, bt, lens, impl="reference",
                                    **szs)
        tol = F32_TOL if dt == torch.float32 else BF16_TOL
        errs[dt], ok = max_err(torch, out, ref, tol)
        report("paged_flash_decode", f"paligemma int8 pool B={B} H={H} "
               f"KV={KV} D={D} q={str(dt)[6:]}", errs[dt], ok, tol)
    n_keys = int(lens.sum())
    n_page_reads = int((-(-lens // page)).sum())
    kd = dref.gather_pages_q8(kp, szs["k_sz"], bt).to(torch.bfloat16)
    vd = dref.gather_pages_q8(vp, szs["v_sz"], bt).to(torch.bfloat16)
    record("paged_flash_decode",
           f"paligemma int8/page pool B={B} H={H} KV={KV} D={D} "
           f"page={page} lengths={lens.tolist()}; library = SDPA, gather "
           "excluded",
           lambda: dops.paged_decode_mha(q, kp, vp, bt, lens, impl="cuda",
                                         **szs),
           lambda: dops.paged_decode_mha(q, kp, vp, bt, lens,
                                         impl="reference", **szs),
           lambda: sdpa_decode_ms(torch, timer, q, kd, vd, lens),
           2 * n_keys * KV * D + 2 * n_page_reads * KV * 2 * 4
           + 2 * q.numel() * 2 + n_page_reads * 4 + B * 4,
           4 * D * H * n_keys, errs[torch.bfloat16])

    # --- write_pages: one paligemma admission, 384 rows ------------------
    nb, P, n_wp = 18, 256, 24
    phys = torch.randperm(P, generator=gen, device="cuda")[:n_wp].to(
        torch.int32)

    def leaf(n, shape, dt):
        if dt == torch.int8:
            return torch.randint(-127, 128, (nb, n, *shape), generator=gen,
                                 device="cuda", dtype=torch.int8)
        return randn(nb, n, *shape, dtype=dt)

    for payload in (torch.bfloat16, torch.int8):
        specs = [((page, KV, D), payload)] * 2
        if payload == torch.int8:        # k, k_sz, v, v_sz
            specs = [specs[0], ((KV, 2), torch.float32)] * 2
        pools = [leaf(P, s_, dt) for s_, dt in specs]
        tiles = [leaf(n_wp, s_, dt) for s_, dt in specs]
        want = [p_.clone() for p_ in pools]
        pops.write_pages_group(want, tiles, phys, impl="reference")
        got = [p_.clone() for p_ in pools]
        pops.write_pages_group(got, tiles, phys, impl="cuda")
        ok = all(torch.equal(a, b) for a, b in zip(got, want))
        report("write_pages", f"paligemma admission {len(pools)} leaves "
               f"nb={nb} KV={KV} D={D} {n_wp * page} rows "
               f"{str(payload)[6:]}", 0.0 if ok else float("inf"), ok, exact)
    phys64 = phys.long()
    record("write_pages", f"paligemma int8 admission k,k_sz,v,v_sz nb={nb} "
           f"KV={KV} D={D} {n_wp * page} rows; library = index_copy_ x4",
           lambda: pops.write_pages_group(pools, tiles, phys, impl="cuda"),
           lambda: pops.write_pages_group(pools, tiles, phys,
                                          impl="reference"),
           lambda: timer(lambda: [p_.index_copy_(1, phys64, t_)
                                  for p_, t_ in zip(pools, tiles)]),
           sum(2 * t_.numel() * t_.element_size() for t_ in tiles)
           + n_wp * 4, 0, 0.0)

    # --- flash_decode: seamless's cross-attention, every length 128 -----
    B, S, H, KV, D = 8, 128, 16, 16, 64
    lens = torch.full((B,), S, dtype=torch.int32, device="cuda")
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        q = randn(B, H, D, dtype=dt)
        k = randn(B, S, KV, D, dtype=dt)
        v = randn(B, S, KV, D, dtype=dt, scale=0.5)
        out = dops.decode_mha(q, k, v, S, impl="cuda")
        ref = dops.decode_mha(q, k, v, S, impl="reference")
        tol = F32_TOL if dt == torch.float32 else BF16_TOL
        errs[dt], ok = max_err(torch, out, ref, tol)
        report("flash_decode", f"seamless cross B={B} S={S} H={H} KV={KV} "
               f"D={D} len={S} {str(dt)[6:]}", errs[dt], ok, tol)
    record("flash_decode", f"seamless cross bf16 B={B} S={S} H={H} KV={KV} "
           f"D={D} every length {S}; library = SDPA with a length mask",
           lambda: dops.decode_mha(q, k, v, S, impl="cuda"),
           lambda: dops.decode_mha(q, k, v, S, impl="reference"),
           lambda: sdpa_decode_ms(torch, timer, q, k, v, lens),
           *reversed(dops.decode_cost(q.shape, k.shape, B * S,
                                      q.element_size())),
           errs[torch.bfloat16])
    return records


# paged_flash_decode at long slots on the main arch's shape (SmolLM-360M:
# int8/page pool, page 16, 15 / 5 heads, D 64): (label, B, capacity in
# keys, lengths), one slot of 16384 keys (past MAX_SPANS spans of 64 keys)
# and 8 of about 2048
LONG_SLOTS = (
    ("B 1 at 16384", 1, 16384, (16384,)),
    ("B 8 at 2048", 8, 2048, (2048, 2048, 2047, 1985, 1700, 1200, 1025, 64)),
)


def long_slot_cases(torch, timer, gen, randn, report) -> list:
    """paged_flash_decode at LONG_SLOTS, the partition past the span cap
    (longer spans walked as tiles of the ring): against its plain version
    with q in float32 (F32_TOL) and bf16 (each element within BF16_TOL's
    atol times the reference's largest |value|, plus one bf16 ulp of the
    element: the outputs, averages of many V rows, are far below 1, so an
    absolute 2e-2 would pass almost anything), timed in bf16 beside
    its bound (the run's lengths), the plain version and SDPA over the K/V
    gathered and dequantized to bf16 beforehand (the gather excluded).
    Returns the timing records."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention import ref as dref

    print("long slots: paged_flash_decode (f32 atol=rtol=1e-5; bf16 "
          "2e-2 * max|ref| + 1 ulp)")
    H, KV, D, page = 15, 5, 64, 16
    records = []
    for label, B, cap, lengths in LONG_SLOTS:
        n_pages = cap // page
        P = B * n_pages
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        bt = torch.stack([torch.randperm(P, generator=gen, device="cuda")
                          [:n_pages] for _ in range(B)]).to(torch.int32)
        kp, vp = (torch.randint(-127, 128, (P, page, KV, D), generator=gen,
                                device="cuda", dtype=torch.int8)
                  for _ in range(2))
        szs = {n: torch.stack([
            0.005 + 0.015 * torch.rand((P, KV), generator=gen, device="cuda"),
            torch.rand((P, KV), generator=gen, device="cuda") - 0.5], -1)
            for n in ("k_sz", "v_sz")}
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            q = randn(B, H, D, dtype=dt)
            out = dops.paged_decode_mha(q, kp, vp, bt, lens, impl="cuda",
                                        **szs)
            ref = dops.paged_decode_mha(q, kp, vp, bt, lens,
                                        impl="reference", **szs)
            case = f"long slot {label} int8/page H={H} KV={KV} D={D} q="
            if dt == torch.float32:
                errs[dt], ok = max_err(torch, out, ref, F32_TOL)
                report("paged_flash_decode", case + "float32", errs[dt], ok,
                       F32_TOL)
                continue
            ref_max = float(ref.float().abs().max())
            tol = dict(atol=BF16_TOL["atol"] * ref_max, rtol=0.0)
            r32 = ref.float()
            ulp = torch.ldexp(torch.ones_like(r32),
                              torch.frexp(r32).exponent - 8)
            err = (out.float() - r32).abs()
            ok = bool((err <= tol["atol"] + ulp).all()
                      and torch.isfinite(out).all())
            errs[dt] = float(err.max())
            report("paged_flash_decode", case + f"bfloat16 max|ref|="
                   f"{ref_max:.3e} +1ulp", errs[dt], ok, tol)
        n_keys = int(lens.sum())
        n_page_reads = int((-(-lens // page)).sum())
        bytes_ = (2 * n_keys * KV * D + 2 * n_page_reads * KV * 2 * 4
                  + 2 * q.numel() * 2 + n_page_reads * 4 + B * 4)
        ops_ = 4 * D * H * n_keys
        t_b, t_o = bytes_ / HBM_BYTES_PER_S, ops_ / PEAK_OPS["bfloat16"]
        kd = dref.gather_pages_q8(kp, szs["k_sz"], bt).to(torch.bfloat16)
        vd = dref.gather_pages_q8(vp, szs["v_sz"], bt).to(torch.bfloat16)
        rec = dict(
            name="paged_flash_decode",
            case=(f"long slot {label}: int8/page B={B} H={H} KV={KV} D={D} "
                  f"page={page} lengths={list(lengths)}; library = SDPA, "
                  "gather excluded"),
            ms=timer(lambda: dops.paged_decode_mha(q, kp, vp, bt, lens,
                                                   impl="cuda", **szs)),
            plain_ms=timer(lambda: dops.paged_decode_mha(
                q, kp, vp, bt, lens, impl="reference", **szs)),
            bound_ms=max(t_b, t_o) * 1e3,
            bound_by="bytes" if t_b >= t_o else "operations",
            library_ms=sdpa_decode_ms(torch, timer, q, kd, vd, lens),
            max_abs_err_bf16=errs[torch.bfloat16])
        print(f"  time paged_flash_decode long slot {label}: kernel "
              f"{rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms library "
              f"{rec['library_ms']} ms bound {rec['bound_ms']:.5f} ms "
              f"({rec['bound_by']}) on {smi_line()}")
        records.append(rec)
        del kp, vp, kd, vd
    return records


def sdpa_decode_ms(torch, timer, q, k, v, lengths):
    """Time of `scaled_dot_product_attention` (with `enable_gqa`) for one
    query token per row against dense K/V (B, S, KV, D) in q's dtype,
    the valid lengths as a boolean mask: the library yardstick of the
    decode kernels, timed only (None on a torch without enable_gqa)."""
    F = torch.nn.functional
    S = k.shape[1]
    qt = q[:, :, None, :]
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    try:
        F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                       enable_gqa=True)
    except TypeError:
        return None
    return timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))


def flash_decode_cases(torch, timer, randn, report, timed):
    """flash_decode against its plain version over the contiguous cache:
    f32 and bf16 x head dims {16, 20, 64, 112, 128, 256} x GQA rep
    {1, 3, 8} x cache extents S {64, 256, 260} (260: the draft caches'
    max_seq + k, a ragged last key span), nine rows per case with
    lengths 0 (the mean of the slot's V rows), 1, span - 1, span, span +
    1 (the split's edges), S // 2 + 3, S, S + 1 and S + 7 (parked), each
    case called three times (the later
    calls bit-equal to the first), then once more with the log-sum-exp
    (`return_lse`): its output bit-equal to the call without, its lse
    against the plain version's (LSE_TOL; -1e30 at length 0). Prints one
    summary line and any failing case; returns the record timed at the
    contiguous engine's decode shape (B=8, 15/5 heads, D=64, S=256,
    bf16), after checking that one op call is one launch of the split
    kernel, and the lse variant's records (`flash_decode_lse_cases`)."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention import paged as dpaged

    print("kernel flash_decode (f32 atol=rtol=1e-5; bf16 atol=2e-2)")
    n_cases, worst = 0, {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_lse = 0.0
    for dt in (torch.float32, torch.bfloat16):
        for D in (16, 20, 64, 112, 128, 256):
            span = dpaged.default_span(D)
            for rep in (1, 3, 8):
                for S in (64, 256, 260):
                    lens = torch.tensor([0, 1, span - 1, span, span + 1,
                                         S // 2 + 3, S, S + 1, S + 7],
                                        dtype=torch.int32, device="cuda")
                    B = lens.numel()
                    q = randn(B, 2 * rep, D, dtype=dt)
                    k = randn(B, S, 2, D, dtype=dt)
                    v = randn(B, S, 2, D, dtype=dt, scale=0.5)
                    out = dops.decode_mha(q, k, v, lens, impl="cuda")
                    ref = dops.decode_mha(q, k, v, lens, impl="reference")
                    tol = F32_TOL if dt == torch.float32 else BF16_TOL
                    err, ok = max_err(torch, out, ref, tol)
                    same = all(torch.equal(out, dops.decode_mha(
                        q, k, v, lens, impl="cuda")) for _ in range(2))
                    o2, lse = dops.decode_mha(q, k, v, lens, impl="cuda",
                                              return_lse=True)
                    _, ref_lse = dops.decode_mha(q, k, v, lens,
                                                 impl="reference",
                                                 return_lse=True)
                    lse_err, lse_ok = max_err(torch, lse, ref_lse, LSE_TOL)
                    same = same and torch.equal(o2, out)
                    n_cases += 1
                    worst[dt] = max(worst[dt], err)
                    worst_lse = max(worst_lse, lse_err)
                    if not (ok and same and lse_ok):
                        report("flash_decode", f"S={S} D={D} rep={rep} "
                               f"{str(dt)[6:]} len={lens.tolist()}"
                               + ("" if same else " REPEAT DIFFERS")
                               + ("" if lse_ok else f" lse {lse_err:.3e}"),
                               err, False, tol)
    print(f"  flash_decode: {n_cases} cases, each called three times "
          f"(bit-equal) and once with the lse (output bit-equal); "
          f"max_abs_err f32 {worst[torch.float32]:.3e}, bf16 "
          f"{worst[torch.bfloat16]:.3e}, lse {worst_lse:.3e}")
    # main shape: the contiguous engine's decode step (prompts of 128
    # tokens, 32 new tokens each, cache extent max_seq = 256)
    B, H, KV, D, S = 8, 15, 5, 64, 256
    q = randn(B, H, D, dtype=torch.bfloat16)
    k = randn(B, S, KV, D, dtype=torch.bfloat16)
    v = randn(B, S, KV, D, dtype=torch.bfloat16, scale=0.5)
    lens = torch.tensor([129, 133, 137, 141, 145, 150, 155, 160],
                        dtype=torch.int32, device="cuda")
    out = dops.decode_mha(q, k, v, lens, impl="cuda")
    ref = dops.decode_mha(q, k, v, lens, impl="reference")
    err, ok = max_err(torch, out, ref, BF16_TOL)
    report("flash_decode", f"main B={B} H={H} KV={KV} D={D} S={S} bf16",
           err, ok, BF16_TOL)
    names = device_kernel_names(torch, lambda: dops.decode_mha(
        q, k, v, lens, impl="cuda"))
    n_split = sum("decode_split_kernel" in n for n in names)
    report("flash_decode", f"main shape: {n_split} launch of the split "
           "kernel per call; " + ", ".join(short_names(names)), 0.0,
           n_split == 1, dict(atol=0, rtol=0))
    # the bound reads the dry-run unit's formula, at this run's lengths
    ops_, bytes_ = dops.decode_cost(q.shape, k.shape,
                                    int(lens.clamp(max=S).sum()),
                                    q.element_size())
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops_ / PEAK_OPS["bfloat16"]
    lse_records = flash_decode_lse_cases(torch, timer, randn, report, timed)
    return [dict(
        name="flash_decode", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/decode_attention.py:57",
        max_abs_err=err,
        **timed(lambda: dops.decode_mha(q, k, v, lens, impl="cuda"),
                lambda: dops.decode_mha(q, k, v, lens, impl="reference")),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=sdpa_decode_ms(torch, timer, q, k, v, lens),
        shape=(f"bf16 contiguous B={B} H={H} KV={KV} D={D} S={S} "
               f"lengths={lens.tolist()}; library = SDPA with a length "
               "mask"),
    )] + lse_records


# the lse variant's rank shapes: (label, B, H, KV, D, S_loc, lengths) —
# one dp2tp2 rank of granite-3-2b's contiguous cell (4 of 8 slots, every
# head, half of max_seq 256; a slot whose keys all sit on the other rank
# has length 0), one rank of qwen2.5-32b's decode_32k on the 16x16 mesh
# (8 of 128 sequences, 2048 of 32768 positions) and a long local block
# (the sequence over 2 ranks)
LSE_SHAPES = (
    ("granite dp2tp2 rank", 4, 32, 8, 64, 128, (0, 33, 100, 128)),
    ("qwen2.5-32b 16x16 rank", 8, 40, 8, 128, 2048,
     (2048, 2048, 1500, 2048, 777, 2048, 2048, 1)),
    ("qwen2.5-32b long block", 1, 40, 8, 128, 16384, (16384,)),
)


def flash_decode_lse_cases(torch, timer, randn, report, timed):
    """flash_decode with `return_lse` (the sequence-sharded decode over
    a mesh: each rank decodes its block of positions and the ranks merge
    by the lse) at LSE_SHAPES, f32 and bf16: out against the plain
    version (F32_TOL / BF16_TOL), lse against its lse (LSE_TOL); each
    timed in bf16 beside its bound (`decode_cost(..., lse=True)` at the
    case's lengths), the plain version and SDPA with a length mask.
    Prints every case; returns the record of the 16x16 rank's shape."""
    from repro_torch.kernels.decode_attention import ops as dops

    print("kernel flash_decode_lse (out f32 atol=rtol=1e-5, bf16 "
          f"atol=2e-2; lse atol={LSE_TOL['atol']:g} "
          f"rtol={LSE_TOL['rtol']:g})")
    record = None
    for label, B, H, KV, D, S, lengths in LSE_SHAPES:
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            q = randn(B, H, D, dtype=dt)
            k = randn(B, S, KV, D, dtype=dt)
            v = randn(B, S, KV, D, dtype=dt, scale=0.5)
            out, lse = dops.decode_mha(q, k, v, lens, impl="cuda",
                                       return_lse=True)
            ref, ref_lse = dops.decode_mha(q, k, v, lens, impl="reference",
                                           return_lse=True)
            tol = F32_TOL if dt == torch.float32 else BF16_TOL
            err, ok = max_err(torch, out, ref, tol)
            lse_err, lse_ok = max_err(torch, lse, ref_lse, LSE_TOL)
            report("flash_decode_lse", f"{label} B={B} H={H} KV={KV} D={D} "
                   f"S_loc={S} {str(dt)[6:]} lse err {lse_err:.2e}",
                   err, ok and lse_ok, tol)
        call = functools.partial(dops.decode_mha, q, k, v, lens,
                                 return_lse=True)
        ops_, bytes_ = dops.decode_cost(q.shape, k.shape,
                                        int(lens.clamp(max=S).sum()),
                                        q.element_size(), lse=True)
        t_b, t_o = bytes_ / HBM_BYTES_PER_S, ops_ / PEAK_OPS["bfloat16"]
        rec = dict(
            name="flash_decode_lse", route="cuda",
            source="src/repro_torch/kernels/csrc/decode_attention.cu",
            replaces="src/repro/kernels/decode_attention/"
                     "decode_attention.py:57",
            max_abs_err=err,
            **timed(lambda: call(impl="cuda"),
                    lambda: call(impl="reference")),
            bound_ms=max(t_b, t_o) * 1e3,
            bound_by="bytes" if t_b >= t_o else "operations",
            library_ms=sdpa_decode_ms(torch, timer, q, k, v, lens),
            shape=(f"bf16 {label}: B={B} H={H} KV={KV} D={D} S_loc={S} "
                   f"lengths={list(lengths)}; library = SDPA with a "
                   "length mask"))
        print(f"  time flash_decode_lse {label}: kernel {rec['ms']:.4f} ms "
              f"plain {rec['plain_ms']:.4f} ms library {rec['library_ms']} "
              f"ms bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}) on "
              f"{smi_line()}")
        if label.endswith("16x16 rank"):
            record = rec
    return [record]


def prefill_kernel_cases(torch, timer, gen, randn, report, timed):
    """The three paged chunked-prefill kernels against their plain
    versions: head dims {16, 20, 64, 112, 128, 256} x pages {16, 64} x
    GQA rep {1, 3, 8}, chunks of one page, two pages and 128 tokens,
    three batch rows per case at chunk starts 0 / one page / deep,
    garbage table entries above each row's frontier; gather-only over
    bf16, f32, int8/page and int8/token pools (int8 with bf16 q, and
    float32 q at D 16, 20, 128), fused over bf16 and f32 pools and the
    int8/page pool, whose written pools must equal the plain version's
    exactly. Then each kernel is timed at SmolLM-360M's chunk shape
    (B=1, C=128, c0=384, 15/5 heads, D=64, page 16, bf16 q), where it
    must run the tensor-core kernel."""
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.flash_attention import ops as fops

    F = torch.nn.functional
    print("kernels paged_prefill_flash / paged_prefill_insert_flash / "
          "paged_prefill_insert_flash_q8 (f32 atol=rtol=1e-5; bf16 "
          "atol=2e-2; written pools exact)")

    def sz(shape):
        scale = torch.rand(shape, generator=gen, device="cuda")
        zero = torch.rand(shape, generator=gen, device="cuda") - 0.5
        return torch.stack([0.005 + 0.015 * scale, zero], -1)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    def inputs(B, C, H, KV, D, page, n_pages, pool, qdt, c0s):
        """q, pools (+ sz) with pages scattered through unique table
        entries, garbage ids above each row's frontier, and the chunk
        operands of the fused kernels."""
        P = B * n_pages
        q = randn(B, C, H, D, dtype=qdt)
        bt = torch.randperm(P, generator=gen, device="cuda")[
            :B * n_pages].view(B, n_pages).to(torch.int32)
        c0 = torch.tensor(c0s, dtype=torch.int32, device="cuda")
        dead = (torch.arange(n_pages, device="cuda")[None, :] * page
                >= (c0 + C)[:, None])
        bt = torch.where(dead, P + 1000, bt).to(torch.int32)
        shape = (P, page, KV, D)
        if pool in ("bf16", "f32"):
            dt = torch.bfloat16 if pool == "bf16" else torch.float32
            return dict(q=q, bt=bt, c0=c0, kp=randn(*shape, dtype=dt),
                        vp=randn(*shape, dtype=dt, scale=0.5),
                        kn=randn(B, C, KV, D, dtype=dt),
                        vn=randn(B, C, KV, D, dtype=dt, scale=0.5))
        sz_shape = (P, KV) if pool == "int8/page" else (P, page, KV)
        return dict(q=q, bt=bt, c0=c0, kp=i8(*shape), vp=i8(*shape),
                    ksz=sz(sz_shape), vsz=sz(sz_shape),
                    kn=i8(B, C, KV, D), vn=i8(B, C, KV, D),
                    kszn=sz((B, C // page, KV)), vszn=sz((B, C // page, KV)))

    def clone(x):
        return {k: v.clone() for k, v in x.items()}

    def call(kind, x, impl):
        """Run one kernel (or its plain version) on `x` in place;
        returns (out, written pools)."""
        if kind == "paged_prefill_flash":
            out = fops.paged_prefill_mha(
                x["q"], x["kp"], x["vp"], x["bt"], x["c0"],
                k_sz=x.get("ksz"), v_sz=x.get("vsz"), impl=impl)
            return out, ()
        if kind == "paged_prefill_insert_flash":
            out = fops.paged_prefill_insert_mha(
                x["q"], x["kp"], x["vp"], x["kn"], x["vn"], x["bt"],
                x["c0"], impl=impl)
            return out[0], (x["kp"], x["vp"])
        out = fops.paged_prefill_insert_mha_q8(
            x["q"], x["kp"], x["vp"], x["ksz"], x["vsz"], x["kn"], x["vn"],
            x["kszn"], x["vszn"], x["bt"], x["c0"], impl=impl)
        return out[0], (x["kp"], x["vp"], x["ksz"], x["vsz"])

    summary: dict = {}

    def check(kind, x, case):
        """Kernel vs plain version on copies of `x`; prints a failing
        case, tallies the passing ones."""
        a, b = clone(x), clone(x)
        out, pools_a = call(kind, a, "cuda")
        ref, pools_b = call(kind, b, "reference")
        exact = x["q"].dtype == torch.float32 and x["kp"].dtype != \
            torch.bfloat16
        tol = F32_TOL if exact else BF16_TOL
        err, ok = max_err(torch, out, ref, tol)
        same = all(torch.equal(p, r) for p, r in zip(pools_a, pools_b))
        if not (ok and same):
            report(kind, case + ("" if same else " POOLS DIFFER"), err,
                   False, tol)
        s = summary.setdefault(kind, {"cases": 0, "max_err_f32": 0.0,
                                      "max_err_bf16": 0.0})
        s["cases"] += 1
        key = "max_err_f32" if exact else "max_err_bf16"
        s[key] = max(s[key], err)
        return err

    chunks = {16: (16, 32, 128), 64: (64, 128)}
    for D in (16, 20, 64, 112, 128, 256):
        for page in (16, 64):
            for rep in (1, 3, 8):
                for C in chunks[page]:
                    n_pages = C // page + 5
                    deep = n_pages * page - C
                    c0s = [0, page, deep]
                    for pool in ("bf16", "f32", "int8/page", "int8/token"):
                        # int8 pools: bf16 q (the tensor-core body) at
                        # every D, float32 q (the FMA body) besides where
                        # the first sweep had it
                        qdts = [torch.bfloat16] if pool == "bf16" else (
                            [torch.float32] if pool == "f32" else
                            [torch.bfloat16] + ([torch.float32] if D in (
                                16, 20, 128) else []))
                        for qdt in qdts:
                            x = inputs(3, C, 2 * rep, 2, D, page, n_pages,
                                       pool, qdt, c0s)
                            kinds = ["paged_prefill_flash"]
                            if pool in ("bf16", "f32"):
                                kinds.append("paged_prefill_insert_flash")
                            elif pool == "int8/page":
                                kinds.append("paged_prefill_insert_flash_q8")
                            for kind in kinds:
                                check(kind, x,
                                      f"C={C} D={D} page={page} rep={rep} "
                                      f"{pool} q={str(qdt)[6:]} c0={c0s}")
    for kind, s in summary.items():
        print(f"  {kind}: {s['cases']} cases; max_abs_err f32 "
              f"{s['max_err_f32']:.3e}, bf16 {s['max_err_bf16']:.3e}; "
              "written pools equal")

    # --- main shape: SmolLM-360M chunk 4 of a 512-token prompt ----------
    B, C, H, KV, D, page, c0 = 1, 128, 15, 5, 64, 16, 384
    n_pages = 544 // page
    records = []
    for kind, pool in (("paged_prefill_insert_flash_q8", "int8/page"),
                       ("paged_prefill_insert_flash", "bf16"),
                       ("paged_prefill_flash", "int8/token")):
        x = inputs(B, C, H, KV, D, page, n_pages, pool, torch.bfloat16,
                   [c0])
        err = check(kind, x, f"main C={C} c0={c0} H={H} KV={KV} D={D} "
                    f"page={page} {pool} q=bfloat16")
        kb = x["kp"].element_size()
        n_keys = c0 + C
        old = c0 if kind != "paged_prefill_flash" else n_keys
        bytes_ = (2 * x["q"].numel() * 2                 # q and o, bf16
                  + 2 * old * KV * D * kb + 4 * n_pages)  # pages read, bt
        if kind != "paged_prefill_flash":
            bytes_ += 2 * 2 * C * KV * D * kb            # chunk in and out
        if pool == "int8/page":
            bytes_ += 2 * (c0 // page) * KV * 2 * 4      # old (scale, zero)
            bytes_ += 2 * 2 * (C // page) * KV * 2 * 4   # chunk rows in, out
        elif pool == "int8/token":
            bytes_ += 2 * n_keys * KV * 2 * 4
        pairs = H * sum(c0 + i + 1 for i in range(C))
        ops_ = 4 * D * pairs
        t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops_ / PEAK_OPS["bfloat16"]
        # library yardstick: SDPA over the K/V gathered and dequantized
        # beforehand (the gather is excluded from its time)
        bt_live = x["bt"][:, :n_keys // page]
        if pool == "bf16":
            kd = dref.gather_pages(x["kp"], bt_live)
            vd = dref.gather_pages(x["vp"], bt_live)
        else:
            kd = dref.gather_pages_q8(x["kp"], x["ksz"], bt_live)
            vd = dref.gather_pages_q8(x["vp"], x["vsz"], bt_live)
        qt = x["q"].transpose(1, 2)
        kt = kd.to(torch.bfloat16).transpose(1, 2).contiguous()
        vt = vd.to(torch.bfloat16).transpose(1, 2).contiguous()
        mask = (torch.arange(C, device="cuda")[:, None] + c0
                >= torch.arange(n_keys, device="cuda")[None, :])
        try:
            F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                           enable_gqa=True)
            lib = timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True))
        except TypeError:          # torch without enable_gqa
            lib = None
        a, b = clone(x), clone(x)
        # bf16 q must run the tensor-core body (mma.sync), not the FMA one
        names = device_kernel_names(torch, lambda: call(kind, a, "cuda"))
        mma = any("paged_prefill_mma_kernel" in n for n in names)
        report(kind, "main shape bf16 q on the tensor-core kernel: "
               + ", ".join(short_names(names)), 0.0, mma,
               dict(atol=0, rtol=0))
        records.append(dict(
            name=kind, route="cuda",
            source="src/repro_torch/kernels/csrc/paged_prefill.cu",
            replaces={"paged_prefill_flash":
                      "src/repro/kernels/flash_attention/paged_prefill.py"
                      ":264",
                      "paged_prefill_insert_flash":
                      "src/repro/kernels/flash_attention/paged_prefill.py"
                      ":343",
                      "paged_prefill_insert_flash_q8":
                      "src/repro/kernels/flash_attention/paged_prefill.py"
                      ":402"}[kind],
            max_abs_err=err,
            **timed(lambda: call(kind, a, "cuda"),
                    lambda: call(kind, b, "reference")),
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=lib,
            shape=(f"{pool} pool B={B} C={C} c0={c0} H={H} KV={KV} D={D} "
                   f"page={page}; library = SDPA, gather excluded"),
        ))
    return records


def lbench_tol(nflop: int) -> dict:
    """The kernel's FFMA rounds once per step where the plain version
    rounds the product and the sum apart: rtol = atol = 2e-5 (the
    reference's own kernel tolerance) up to nflop 128; longer chains
    gather about one rounding per step where |x| is near 1, so
    nflop * 1e-7 from 256 on."""
    t = 2e-5 if nflop <= 128 else nflop * 1e-7
    return dict(atol=t, rtol=t)


def lbench_close(torch, out, ref, tol) -> tuple[float, float, bool, int]:
    """(max abs error and max |err| / (1 + |ref|), the tolerance's own
    measure since atol = rtol, over the elements finite in both; ok;
    elements finite in one and infinite in the other). nan positions
    must be equal; an inf compares as +-FLT_MAX, so an element that
    overflows in one version and lands within the tolerance of FLT_MAX in
    the other agrees (the fused and unfused chains round apart at the
    overflow edge), and every other inf must sit at the same position."""
    big = torch.finfo(torch.float32).max
    o, r = out.double(), ref.double()
    on, rn = o.isnan(), r.isnan()
    if not torch.equal(on, rn):
        return float("inf"), float("inf"), False, 0
    fin = o.isfinite() & r.isfinite()
    err = scaled = 0.0
    if bool(fin.any()):
        d = (o - r)[fin].abs()
        err = float(d.max())
        scaled = float((d / (1.0 + r[fin].abs())).max())
    oc = torch.where(on, 0.0, o).clamp(-big, big)
    rc = torch.where(rn, 0.0, r).clamp(-big, big)
    ok = bool(((oc - rc).abs() <= tol["atol"] + tol["rtol"] * rc.abs())
              .all())
    return err, scaled, ok, int((o.isinf() != r.isinf()).sum())


def lbench_cases(torch, timer, gen, report, timed):
    """LBench against its plain version over nflop {0, 1, 2, 5, 16, 32,
    128, 1024} x sizes {1, 129, 4096, 2^20 + 3, 2^28}, plus a view one
    element in (not 16-byte aligned: the scalar path). Prints one line
    per size and any failing case; returns the record timed at 2^28
    elements, nflop 2 (library: `torch.addcmul(alpha, x, x)`, one
    elementwise kernel computing the same x * x + alpha)."""
    from repro_torch.kernels.lbench import ops as lops

    print("kernel lbench (rtol=atol=2e-5 up to nflop 128, nflop*1e-7 "
          "above; inf compares as FLT_MAX)")
    nflops = (0, 1, 2, 5, 16, 32, 128, 1024)

    def case(x, label):
        worst, edge = [], 0
        for nflop in nflops:
            out = lops.lbench(x, nflop, impl="cuda")
            ref = lops.lbench(x, nflop, impl="reference")
            tol = lbench_tol(nflop)
            err, scaled, ok, n_edge = lbench_close(torch, out, ref, tol)
            worst.append(f"{nflop}:{scaled:.1e}")
            edge += n_edge
            if not ok:
                report("lbench", f"{label} nflop={nflop}", err, ok, tol)
            del out, ref
        print(f"  lbench {label}: max |err| / (1 + |ref|) by nflop "
              f"{' '.join(worst)}; inf vs finite {edge}")

    for n in (1, 129, 4096, 2**20 + 3, 2**28):
        case(torch.randn(n, generator=gen, device="cuda"), f"n={n}")
    case(torch.randn(4097, generator=gen, device="cuda")[1:],
         "n=4096 offset by one element")
    n, nflop = 2**28, 2
    x = torch.randn(n, generator=gen, device="cuda")
    tol = lbench_tol(nflop)
    err, _, ok, _ = lbench_close(torch, lops.lbench(x, nflop, impl="cuda"),
                                 lops.lbench(x, nflop, impl="reference"),
                                 tol)
    report("lbench", f"main n=2^28 nflop={nflop}", err, ok, tol)
    t_bytes = lops.bytes_moved(n) / HBM_BYTES_PER_S
    t_ops = lops.flops(n, nflop) / PEAK_OPS["float32"]
    alpha = torch.tensor(0.5, device="cuda")
    return dict(
        name="lbench", route="cuda",
        source="src/repro_torch/kernels/csrc/lbench.cu",
        replaces="src/repro/kernels/lbench/lbench.py:32",
        max_abs_err=err,
        **timed(lambda: lops.lbench(x, nflop, impl="cuda"),
                lambda: lops.lbench(x, nflop, impl="reference")),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=timer(lambda: torch.addcmul(alpha, x, x)),
        shape=(f"f32 n=2^28 nflop={nflop}; library = torch.addcmul(alpha, "
               "x, x)"),
    )


def int_mm_ms(torch, timer, a8, b8, sa, sb, out):
    """Time of `torch._int_mm` plus the scale epilogue (the library
    yardstick of matmul_w8a8; None where `_int_mm` refuses the shape)
    and whether it equals the kernel's output bit for bit."""
    def lib():
        return torch._int_mm(a8, b8).float() * sa[:, None] * sb[None, :]

    try:
        same = torch.equal(lib(), out)
    except RuntimeError as e:
        print(f"  torch._int_mm refuses {tuple(a8.shape)} @ "
              f"{tuple(b8.shape)}: {str(e).splitlines()[0]}")
        return None, None
    return timer(lib), same


def w8a8_times(torch, timer, a8, b8, sa, sb, out) -> dict:
    """The library yardstick (`lib` ms, `_int_mm` + epilogue, and whether
    it is bit-equal to the kernel's `out`, `same`), bf16 `torch.matmul`
    of the dequantized operands (`bf16` ms) and the bound (`bound` s,
    `bound_by`, from `t_bytes` and `t_ops`) for one shape."""
    M, K = a8.shape
    N = b8.shape[1]
    lib_ms, same = int_mm_ms(torch, timer, a8, b8, sa, sb, out)
    af = (a8.float() * sa[:, None]).to(torch.bfloat16)
    bf = (b8.float() * sb[None, :]).to(torch.bfloat16)
    t_bytes = (M * K + K * N + 4 * (M + N) + 4 * M * N) / HBM_BYTES_PER_S
    t_ops = 2 * M * N * K / PEAK_OPS["int8"]
    return dict(lib=lib_ms, same=same, bf16=timer(lambda: af @ bf),
                t_bytes=t_bytes, t_ops=t_ops, bound=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def w8a8_cases(torch, timer, randn, report, timed):
    """matmul_w8a8 against its plain version, bit for bit: the reference
    test's shapes (128^3, 256x384x256, 130x96x200, 1x128x256), a ragged
    33x97x203 (byte loads), SmolLM-360M's MLP shapes at published widths
    (M in {8, 1024}; K x N = 960 x 2560 and 2560 x 960) and all-zero
    operands, each through the default launch plan and, at the ragged
    and the MLP shapes, every other block tile. Checks by kernel name
    that the main shape runs the int8 tensor-core kernel, once. Prints
    the decode-like M=8 shape's times; returns the record timed at
    M=1024, K=960, N=2560 (library: `torch._int_mm` plus the scale
    epilogue; bf16 `torch.matmul` printed beside it)."""
    from repro_torch.kernels.matmul_w8a8 import matmul_w8a8 as mm
    from repro_torch.kernels.matmul_w8a8 import ops as wops

    print("kernel matmul_w8a8 (exact)")
    shapes = [(128, 128, 128), (256, 384, 256), (130, 96, 200),
              (1, 128, 256), (33, 97, 203), (8, 960, 2560),
              (8, 2560, 960), (1024, 2560, 960), (1024, 960, 2560)]
    for M, K, N in shapes:
        a8, sa = wops.quantize_rows(randn(M, K))
        b8, sb = wops.quantize_rows(randn(K, N, scale=0.5), axis=0)
        out = wops.matmul_w8a8(a8, b8, sa, sb, impl="cuda")
        ref = wops.matmul_w8a8(a8, b8, sa, sb, impl="reference")
        ok = torch.equal(out, ref)
        report("matmul_w8a8", f"M={M} K={K} N={N}",
               float((out - ref).abs().max()), ok, dict(atol=0, rtol=0))
        if (M, K, N) in ((33, 97, 203), (8, 960, 2560), (1024, 960, 2560)):
            for tile in mm.TILES:
                o = mm.matmul_w8a8_cuda(a8, b8, sa, sb,
                                        plan=mm.launch_plan(M, N, tile))
                report("matmul_w8a8", f"M={M} K={K} N={N} tile {tile}",
                       float((o - ref).abs().max()), torch.equal(o, ref),
                       dict(atol=0, rtol=0))
    z8, sz = wops.quantize_rows(torch.zeros(64, 128, device="cuda"))
    w8, sw = wops.quantize_rows(torch.zeros(128, 64, device="cuda"), axis=0)
    out = wops.matmul_w8a8(z8, w8, sz, sw, impl="cuda")
    ok = torch.equal(out, wops.matmul_w8a8(z8, w8, sz, sw,
                                           impl="reference"))
    ok = ok and not bool(out.any())
    report("matmul_w8a8", "zero operands M=64 K=128 N=64", 0.0, ok,
           dict(atol=0, rtol=0))
    # the decode-like shape, timed beside the main one
    a8, sa = wops.quantize_rows(randn(8, 960))
    b8, sb = wops.quantize_rows(randn(960, 2560, scale=0.5), axis=0)
    out = wops.matmul_w8a8(a8, b8, sa, sb, impl="cuda")
    small = w8a8_times(torch, timer, a8, b8, sa, sb, out)
    t = timed(lambda: wops.matmul_w8a8(a8, b8, sa, sb, impl="cuda"),
              lambda: wops.matmul_w8a8(a8, b8, sa, sb, impl="reference"))
    print(f"  time matmul_w8a8 M=8 K=960 N=2560: kernel {t['ms']:.4f} ms, "
          f"plain {t['plain_ms']:.4f} ms, _int_mm + epilogue "
          f"{small['lib']} ms (bit-equal "
          f"{small['same']}), bf16 matmul {small['bf16']:.4f} ms, bound "
          f"{small['bound'] * 1e3:.5f} ms ({small['bound_by']})")
    # the main shape: the MLP up/gate product of the quantify phase
    a8, sa = wops.quantize_rows(randn(1024, 960))
    b8, sb = wops.quantize_rows(randn(960, 2560, scale=0.5), axis=0)
    M, K = a8.shape
    N = b8.shape[1]
    out = wops.matmul_w8a8(a8, b8, sa, sb, impl="cuda")
    ok = torch.equal(out, wops.matmul_w8a8(a8, b8, sa, sb,
                                           impl="reference"))
    names = device_kernel_names(torch, lambda: wops.matmul_w8a8(
        a8, b8, sa, sb, impl="cuda"))
    n_mma = sum("matmul_w8a8_mma_kernel" in n for n in names)
    report("matmul_w8a8", f"main shape on the int8 tensor cores: {n_mma} "
           "launch; " + ", ".join(short_names(names)), 0.0,
           ok and n_mma == 1 and len(names) == 1, dict(atol=0, rtol=0))
    main = w8a8_times(torch, timer, a8, b8, sa, sb, out)
    lib_ms, same, bf16_ms = main["lib"], main["same"], main["bf16"]
    t_bytes, t_ops = main["t_bytes"], main["t_ops"]
    return dict(
        name="matmul_w8a8", route="cuda",
        source="src/repro_torch/kernels/csrc/matmul_w8a8.cu",
        replaces="src/repro/kernels/matmul_w8a8/matmul_w8a8.py:53",
        max_abs_err=0.0,
        **timed(lambda: wops.matmul_w8a8(a8, b8, sa, sb, impl="cuda"),
                lambda: wops.matmul_w8a8(a8, b8, sa, sb, impl="reference")),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=lib_ms,
        shape=(f"M={M} K={K} N={N} (SmolLM-360M MLP up/gate); library = "
               f"torch._int_mm + scale epilogue (bit-equal to the kernel: "
               f"{same}); bf16 torch.matmul {bf16_ms:.4f} ms"),
    )


# ------------------------------------------------------------- quantify
def ssd_cases(torch, timer, gen, report, timed):
    """ssd_scan against its plain version (the chunked form of
    `kernels/ssd_scan/chunked.py`) on the same inputs, evaluated in
    float64 (the plain version computes in float64 for float64 inputs),
    y and the final state: the reference test's four shapes, mamba2-780m's
    widths (H=48, P=64, G=1, N=128) at B {1, 8} x S {64, 128, 256}, a
    ragged S = 100, G = 2, D = None and a given initial state, each in
    float32 and bf16 (x, B, C and y; dt, A, D and the states float32).
    Tolerance: float32 y and every state atol = rtol = 2e-4 (the
    reference's own, against its exact scan); bf16 y atol = 2e-2, rtol =
    8e-3 (rounded once to bf16: one ulp is at most 2^-7 relative). The
    float32 plain version's own distance from the float64 evaluation and
    from the kernel are printed too: at N = 128 its float32 cumsum
    differences lose more than 2e-4. Prints one summary line and any
    failing case. Then every launch-plan option of the bf16 tensor-core
    body (pb 16, 32, 64 x one or two chunk stages) at mamba2's widths,
    B=1 and B=8, at the same tolerances, and a check by kernel name that
    the main shape runs the tensor-core body once. Returns the record
    timed at the engine's prefill shape (B=1, S=128, bf16, D given, no
    initial state)."""
    from repro_torch.kernels.ssd_scan import chunked
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan import ssd_scan as sks

    F = torch.nn.functional
    f32_tol = dict(atol=2e-4, rtol=2e-4)
    bf16_tol = dict(atol=2e-2, rtol=8e-3)
    print("kernel ssd_scan vs the plain version in float64 (f32 "
          "atol=rtol=2e-4; bf16 y atol=2e-2 rtol=8e-3; states 2e-4)")

    def inputs(B, S, H, P, G, N, dtype, with_D=True, init=False):
        def rn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")

        return (rn(B, S, H, P).to(dtype), F.softplus(rn(B, S, H)),
                -torch.exp(rn(H) * 0.5), rn(B, S, G, N).to(dtype),
                rn(B, S, G, N).to(dtype), rn(H) if with_D else None,
                rn(B, H, P, N) * 0.1 if init else None)

    plain_worst = [0.0, 0.0]      # float32 plain vs float64, vs kernel

    def check(args, chunk, label):
        y, h = sops.ssd(*args, impl="cuda")
        y64, h64 = chunked.ssd_chunked(
            *(None if a is None else a.double() for a in args), chunk=chunk)
        tol = f32_tol if args[0].dtype == torch.float32 else bf16_tol
        ey, oky = max_err(torch, y, y64.to(y.dtype), tol)
        eh, okh = max_err(torch, h, h64, f32_tol)
        if not (oky and okh):
            report("ssd_scan", f"{label} y", ey, oky, tol)
            report("ssd_scan", f"{label} state", eh, okh, f32_tol)
        if args[0].dtype == torch.float32:
            y32, _ = chunked.ssd_chunked(*args, chunk=chunk)
            plain_worst[0] = max(plain_worst[0],
                                 float((y32.double() - y64).abs().max()))
            plain_worst[1] = max(plain_worst[1],
                                 float((y32 - y).abs().max()))
        return ey, eh, oky and okh

    cases = [((2, 256, 4, 16, 1, 32), 64, {}), ((1, 128, 4, 32, 2, 16), 32,
                                                {}),
             ((2, 128, 8, 16, 1, 64), 128, {}), ((1, 192, 2, 8, 1, 8), 64,
                                                 {})]
    for B in (1, 8):
        for S in (64, 128, 256):
            cases.append(((B, S, 48, 64, 1, 128), 128, {}))
    cases += [((1, 100, 48, 64, 1, 128), 128, {}),
              ((2, 128, 48, 64, 2, 128), 128, {}),
              ((2, 128, 48, 64, 1, 128), 128, dict(with_D=False)),
              ((2, 160, 48, 64, 1, 128), 128, dict(init=True))]
    n_cases, worst, n_bad = 0, {}, 0
    for dtype in (torch.float32, torch.bfloat16):
        for shape, chunk, kw in cases:
            B, S, H, P, G, N = shape
            ey, eh, ok = check(inputs(*shape, dtype, **kw), chunk,
                               f"B={B} S={S} H={H} P={P} G={G} N={N} "
                               f"{str(dtype)[6:]} {kw or ''}")
            n_cases += 1
            n_bad += not ok
            w = worst.setdefault(str(dtype)[6:], [0.0, 0.0])
            w[0], w[1] = max(w[0], ey), max(w[1], eh)
    print(f"  ssd_scan: {n_cases} cases, {n_bad} failing; max_abs_err "
          + ", ".join(f"{k} y {v[0]:.3e} state {v[1]:.3e}"
                      for k, v in worst.items())
          + f"; the float32 plain version's y differs from its float64 "
          f"evaluation by up to {plain_worst[0]:.3e} and from the kernel "
          f"by up to {plain_worst[1]:.3e}")
    # every plan option of the tensor-core body at mamba2's widths, B=1
    # and B=8, on one input each (held like the sweep)
    for B in (1, 8):
        args = inputs(B, 128, 48, 64, 1, 128, torch.bfloat16)
        y64, h64 = chunked.ssd_chunked(
            *(None if a is None else a.double() for a in args), chunk=128)
        for pb in sks.MMA_PB:
            for stages in (1, 2):
                y, h = sks.ssd_cuda(*args, plan=sks.launch_plan(
                    B, 48, 64, 128, torch.bfloat16, pb, stages))
                ey, oky = max_err(torch, y, y64.to(y.dtype), bf16_tol)
                eh, okh = max_err(torch, h, h64, f32_tol)
                n_cases += 1
                if not (oky and okh):
                    report("ssd_scan", f"B={B} pb={pb} stages={stages} y",
                           ey, oky, bf16_tol)
                    report("ssd_scan", f"B={B} pb={pb} stages={stages} "
                           "state", eh, okh, f32_tol)
    B, S, H, P, G, N = 1, 128, 48, 64, 1, 128
    args = inputs(B, S, H, P, G, N, torch.bfloat16)
    err, _, ok = check(args, 128, "main")
    report("ssd_scan", f"main B={B} S={S} H={H} P={P} N={N} bf16", err, ok,
           bf16_tol)
    # one launch of the tensor-core body per call, no FMA body
    names = device_kernel_names(torch, lambda: sops.ssd(*args, impl="cuda"))
    n_mma = sum("ssd_mma_kernel" in n for n in names)
    n_fma = sum("ssd_fma_kernel" in n for n in names)
    report("ssd_scan", f"main shape: {n_mma} launch of the tensor-core "
           f"body, {n_fma} of the FMA body; " + ", ".join(
               short_names(names)), 0.0, n_mma == 1 and n_fma == 0,
           dict(atol=0, rtol=0))
    print(f"  ssd_scan: {n_cases} cases with the plan options; main plan "
          f"{sks.launch_plan(B, H, P, N, torch.bfloat16)}")
    # the formula the dry-run's ssd_scan unit reads
    n_ops, nbytes = sops.ssd_cost(
        args[0].shape, args[3].shape, itemsize=args[0].element_size(),
        b_itemsize=args[3].element_size(), has_D=args[5] is not None,
        has_init=args[6] is not None)
    t_bytes = nbytes / HBM_BYTES_PER_S
    # the bf16 body's products run on the tensor cores (bf16 peak); the
    # float32 FMA body's bound is printed beside it
    t_ops = n_ops / PEAK_OPS["bfloat16"]
    t_fma = n_ops / PEAK_OPS["float32"]
    return dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/ssd_scan.py:26",
        max_abs_err=err,
        **timed(lambda: sops.ssd(*args, impl="cuda"),
                lambda: chunked.ssd_chunked(*args)),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None,
        shape=(f"bf16 B={B} S={S} H={H} P={P} G={G} N={N} "
               f"({nbytes / 1e6:.2f} MB, "
               f"{n_ops / 1e9:.3f} GFLOP at Q={sks.Q}; "
               f"bound on the bf16 tensor cores; the float32 FMA body's "
               f"{max(t_bytes, t_fma) * 1e3:.4f} ms); no single PyTorch "
               "call computes the chunked SSD"),
    )


def chain_check(np, x, out, nflop: int, alpha: float = 0.5, n: int = 4096):
    """The first `n` outputs of LBench against the chain computed on the
    host in float64 (independent of the port's plain version): within
    `lbench_tol(nflop)` relative to 1 + |chain| where the chain stays below
    1e37, infinite where it passes 1e39."""
    xs = x[:n].double().cpu().numpy()
    o = out[:n].double().cpu().numpy()
    with np.errstate(over="ignore", invalid="ignore"):
        b = xs + alpha if nflop % 2 else xs.copy()
        for _ in range(nflop // 2):
            b = b * xs + alpha
    tol = lbench_tol(nflop)["rtol"]
    fin = np.abs(b) < 1e37
    err = np.abs(o[fin] - b[fin]) / (1.0 + np.abs(b[fin]))
    assert err.max(initial=0.0) <= tol, (nflop, float(err.max()))
    assert not np.isfinite(o[np.abs(b) > 1e39]).any(), nflop


def quantify_phase(torch):
    """The analysis path on the card: the Fig 11 script
    (`scripts/lbench_torch.py`) at 2^28 elements, the LBench sweep
    extended past the ridge with measured GB/s, GFLOP/s and ridge, and
    one W8A8 call per SmolLM-360M MLP shape. Returns the launches of
    lbench and matmul_w8a8 in this run; no plain version may run."""
    import numpy as np

    import lbench_torch
    from repro_torch import configs, kernels
    from repro_torch.kernels.lbench import ops as lops
    from repro_torch.kernels.matmul_w8a8 import ops as wops

    dev = torch.device("cuda")
    torch.cuda.synchronize()
    kernels.reset_counters()
    print("quantify: scripts/lbench_torch.run() (paper Fig 11) on the card")
    rows = lbench_torch.run(device="cuda")
    left = [r for r in rows if r["panel"] == "left"]
    assert len(left) == 2 * len(lbench_torch.LEFT_NFLOPS), left
    assert [r["arch"] for r in rows if r["panel"] == "right"] == \
        configs.list_archs()

    n = lbench_torch.HBM_ELEMENTS
    print(f"quantify: LBench sweep at 2^28 elements (CUDA events over 10 "
          f"calls; bound = max(8n / {HBM_BYTES_PER_S:g} B/s, nflop*n / "
          f"{PEAK_OPS['float32']:g} flop/s))")
    a = torch.randn(n, generator=torch.Generator(dev).manual_seed(1),
                    device=dev)
    pts = []
    for nflop in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024):
        p = lbench_torch.lbench_point(a, nflop)
        chain_check(np, a, p.pop("out"), nflop)
        bound_us = max(lops.bytes_moved(n) / HBM_BYTES_PER_S,
                       lops.flops(n, nflop) / PEAK_OPS["float32"]) * 1e6
        print(f"  nflop={nflop:5d} us={p['us']:10.1f} "
              f"GB/s={p['gbps']:8.1f} GFLOP/s={p['gflops']:9.1f} "
              f"bound_us={bound_us:9.1f} share_of_bound="
              f"{bound_us / p['us']:.3f}")
        pts.append(p)
    bw = max(p["gbps"] for p in pts)
    fl = max(p["gflops"] for p in pts)
    ridge = 8.0 * fl / bw
    print(f"  measured roofs {bw:.1f} GB/s and {fl:.1f} GFLOP/s: ridge at "
          f"nflop {ridge:.1f} ({ridge / 8:.2f} flop/B) against the data "
          f"sheet's {8 * PEAK_OPS['float32'] / HBM_BYTES_PER_S:.1f} "
          f"({PEAK_OPS['float32'] / HBM_BYTES_PER_S:.2f} flop/B)")
    del a

    print("quantify: W8A8 at SmolLM-360M's MLP shapes (CUDA events over "
          "10 calls; output against the f32 product of the same operands)")
    gen = torch.Generator(dev).manual_seed(2)
    for M in (8, 1024):
        for K, N in ((960, 2560), (2560, 960)):
            x = torch.randn(M, K, generator=gen, device=dev)
            w = torch.randn(K, N, generator=gen, device=dev) * K ** -0.5
            x8, sx = wops.quantize_rows(x)
            w8, sw = wops.quantize_rows(w, axis=0)
            out, us = lbench_torch.timed(
                lambda: wops.matmul_w8a8(x8, w8, sx, sw), dev)
            fp = x @ w
            drift = float((out - fp).abs().max() / fp.abs().max())
            assert out.shape == (M, N) and drift < 0.05, (M, K, N, drift)
            print(f"  M={M:5d} K={K} N={N} us={us:8.1f} "
                  f"TOP/s={2 * M * N * K / us / 1e6:7.2f} "
                  f"drift_vs_f32={drift:.4f}")
    launches = dict(kernels.LAUNCHES)
    plain = dict(kernels.REFERENCE_CALLS)
    print(f"  launches {launches} plain_calls {plain}")
    assert launches["lbench"] > 0 and launches["matmul_w8a8"] > 0, launches
    assert not any(plain.values()), plain
    return {k: launches[k] for k in ("lbench", "matmul_w8a8")}


# -------------------------------------------------------------- engine
def agreement(a, b) -> float:
    n = max(len(a), len(b))
    return sum(x == y for x, y in zip(a, b)) / n if n else 1.0


BUCKET_KERNELS = ("write_pages", "flash_mha", "paged_flash_decode")


def divergence_report(torch, cfg, params, kreqs, rreqs) -> None:
    """For each request whose kernel and plain-version tokens differ:
    the first differing position, the two tokens, and the logits of the
    prompt plus the common tokens (teacher-forced prefill, once with the
    kernels and once with the plain versions): how far apart the two
    candidates are in each, beside the largest |logit|. A gap near
    bf16's rounding marks a near-tie that any reordering may flip."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.models import model as M
    from repro_torch.models.module import cast_params

    p = cast_params(params, cfg.dtype)
    for a, b in zip(kreqs, rreqs):
        i = next((j for j, (x, y) in enumerate(zip(a.output, b.output))
                  if x != y), None)
        if i is None:
            continue
        toks = torch.as_tensor(np.concatenate(
            [a.tokens, np.asarray(a.output[:i], dtype=a.tokens.dtype)])[None],
            device="cuda")
        gaps = {}
        for backend in (None, "reference"):
            kernels.force_backend(backend)
            try:
                logits = M.prefill(p, {"tokens": toks}, cfg,
                                   max_seq=toks.shape[1])[1][0].float()
            finally:
                kernels.force_backend(None)
            gaps[backend or "kernels"] = (
                float(logits[a.output[i]] - logits[b.output[i]]),
                float(logits.abs().max()))
        print(f"    request {a.request_id}: first differing token {i} of "
              f"{len(a.output)} (kernels {a.output[i]}, plain "
              f"{b.output[i]}); teacher-forced logit(kernels' token) - "
              f"logit(plain's token): kernels {gaps['kernels'][0]:+.4f}, "
              f"plain {gaps['reference'][0]:+.4f} (max |logit| "
              f"{gaps['reference'][1]:.3f})")


def watch_substrate(eng) -> list:
    """Hold the engine's substrate to the reference's placement contract
    after every drain: the pager's pool footprint minus the ledger's
    placement bytes (the gap, 0 when they agree) is appended to the list
    returned; empty when the engine has no substrate."""
    gaps: list = []
    sub = eng.substrate
    if sub is None:
        return gaps
    drain = sub.drain

    def checked(pager, caches, *, step=0):
        out = drain(pager, caches, step=step)
        gaps.append(pager.pool_bytes_used() - sub.ledger.placement_bytes())
        return out

    sub.drain = checked
    return gaps


def substrate_line(eng, stats, gaps) -> str:
    """The substrate's mode, streams and placement gap of one run."""
    if eng.substrate is None:
        return "substrate: none"
    s = stats.substrate
    worst = max((abs(g) for g in gaps), default=0.0)
    return (f"substrate {eng.substrate.mode}: page_out "
            f"{s['page_out_pages']} pages {s['page_out_bytes']:.0f} B, "
            f"page_in {s['page_in_pages']} pages {s['page_in_bytes']:.0f} "
            f"B, drop {s['drop_pages']} pages; {len(gaps)} drains, max "
            f"|placement gap| {worst:.0f} B")


def engine_phase(torch):
    """Serve the chat trace at full width; returns the launches of the
    bucket path's kernels in the int8 kernel run (the main path)."""
    from repro_torch import configs, kernels
    from repro_torch.models import model as M
    from repro_torch.serving import (INT8_TOKEN_AGREEMENT, EngineConfig,
                                     ServingEngine, make_scenario)

    cfg = configs.get("smollm_360m")              # bf16 activations
    assert cfg.dtype == "bfloat16"
    base = EngineConfig(n_slots=8, max_seq=256, prefill_buckets=(64, 128),
                        page_tokens=16, pool_dtype="int8")
    params = M.init_model(cfg, torch.Generator("cuda").manual_seed(0))
    print(f"engine {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"H={cfg.num_heads}/{cfg.num_kv_heads} hd={cfg.head_dim} "
          f"ff={cfg.d_ff} vocab={cfg.vocab_size}, random weights seed 0")

    def serve(pool_dtype, backend, profiled=False, substrate="auto",
              n_req=16):
        kernels.force_backend(backend)
        try:
            eng = ServingEngine.build(
                cfg, dataclasses.replace(base, pool_dtype=pool_dtype,
                                         substrate=substrate),
                params=params)
            gaps = watch_substrate(eng)
            reqs = make_scenario("chat", n_req, cfg.vocab_size, seed=0,
                                 prompt_buckets=(64, 128),
                                 gen_range=(16, 32), arrival_rate=1e5)
            torch.cuda.synchronize()
            kernels.reset_counters()
            if profiled:
                return profile_run(torch, eng, reqs)
            stats = eng.run(reqs)
            launches = dict(kernels.LAUNCHES)
            plain = dict(kernels.REFERENCE_CALLS)
        finally:
            kernels.force_backend(None)
        assert stats.n_requests == len(reqs)
        for r in reqs:
            assert len(r.output) == r.max_new_tokens, r.request_id
        s = stats.summary()
        print(f"  pool={pool_dtype:4s} backend={backend or 'kernels':9s} "
              f"requests={s['n_requests']} tokens={s['tokens']} "
              f"steps={s['steps']} wall_s={stats.wall_s:.3f} "
              f"tok_per_s_wall={s['tok_per_s_wall']:.1f} "
              f"max_concurrency={s['max_concurrency']} "
              f"launches={launches} plain_calls={plain}")
        print(f"    {substrate_line(eng, stats, gaps)}")
        if substrate == "auto":
            assert eng.substrate.mode == "physical", eng.substrate.mode
            assert gaps and all(g == 0 for g in gaps), gaps
        return reqs, launches, plain

    main_launches = None
    for pool in ("int8", "fp"):
        kreqs, launches, plain = serve(pool, None)
        assert all(launches[k] > 0 for k in BUCKET_KERNELS), launches
        assert not any(plain.values()), plain
        # one grouped page write per admission
        assert launches["write_pages"] == len(kreqs), launches
        if pool == "int8":
            main_launches = launches
        oreqs, _, _ = serve(pool, None, substrate="off")
        same = [a.output == b.output for a, b in zip(kreqs, oreqs)]
        print(f"  pool={pool}: tokens with the substrate on == off: "
              f"{sum(same)} of {len(same)} requests (gate: all)")
        assert all(same), same
        rreqs, rlaunch, _ = serve(pool, "reference")
        assert not any(rlaunch.values()), rlaunch
        agree = [agreement(a.output, b.output) for a, b in zip(kreqs, rreqs)]
        print(f"  pool={pool}: per-request token agreement kernels vs "
              f"plain: min={min(agree):.3f} mean="
              f"{sum(agree) / len(agree):.3f} (gate >= "
              f"{INT8_TOKEN_AGREEMENT})")
        divergence_report(torch, cfg, params, kreqs, rreqs)
        assert min(agree) >= INT8_TOKEN_AGREEMENT, agree
    # the profiled run is cut to 2 requests (the gates above run on all
    # 16): reading the 16-request trace's events took a quarter minute,
    # 4 requests' 11.7 s
    serve("int8", None, profiled=True, n_req=2)
    return {k: main_launches[k] for k in BUCKET_KERNELS}


def substrate_phase(torch):
    """The physical substrate on the card. First the page streams alone:
    SmolLM-360M's int8 pool at P=4096 pages (k, v and their (scale, zero)
    leaves, 1.35 GB) with a pinned host twin of the same size; bursts of
    1, 8, 64, 512 and 4096 random pages through page_out (pool -> twin)
    and page_in (twin -> device scratch), each checked bit for bit,
    against the data sheet's 64 GB/s host link, a contiguous
    `copy_(non_blocking=True)` of the same bytes to and from a pinned
    buffer (cudaMemcpyAsync) and the plain index_select + copy. Then the
    engine phase's configuration (the model cut to DEPTH's 8 layers) and
    trace with the local tier cut to a
    quarter of peak KV (local_budget_frac=0.25), so pages spill to the
    pool tier and come back: mode "physical", placement gap 0 after
    every drain, tokens equal to the same engine with the substrate off,
    one grouped page write per admission. Returns page_out's and
    page_in's launches in that run."""
    from repro_torch import configs, kernels
    from repro_torch.common import hw
    from repro_torch.kernels.page_io import ops as pops
    from repro_torch.models import model as M
    from repro_torch.serving import EngineConfig, ServingEngine, make_scenario

    cfg = configs.get("smollm_360m")
    nb, page, KV, D, P = cfg.num_layers, 16, cfg.num_kv_heads, cfg.head_dim, \
        4096
    gen = torch.Generator("cuda").manual_seed(2)
    shapes = [((nb, P, page, KV, D), torch.int8),
              ((nb, P, KV, 2), torch.float32)] * 2
    pool = [torch.randint(-127, 128, sh, generator=gen, device="cuda",
                          dtype=dt) if dt == torch.int8 else
            torch.randn(sh, generator=gen, device="cuda") for sh, dt in shapes]
    twin = [torch.zeros(sh, dtype=dt, pin_memory=True) for sh, dt in shapes]
    page_bytes = sum(t[:, 0].numel() * t.element_size() for t in pool)
    big = P * page_bytes
    host = torch.empty(big, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(big, dtype=torch.uint8, device="cuda")
    link = hw.H100_HOST.pcie_bw
    print(f"substrate streams: {cfg.name} int8 pool of {P} pages, "
          f"{page_bytes} B a page over {nb} levels (k, v 5120 B + 2 x 40 B "
          f"a level), {big / 1e9:.3f} GB on the card and in pinned host "
          f"memory; GB/s against the data sheet's host link "
          f"{link / 1e9:.0f} GB/s (common/hw.py H100_HOST.pcie_bw)")

    def ev_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    rows = []
    for burst in (1, 8, 64, 512, 4096):
        ids = torch.randperm(P, generator=gen, device="cuda")[:burst].to(
            torch.int32)
        scratch = [torch.empty((nb, burst, *t.shape[2:]), dtype=t.dtype,
                               device="cuda") for t in pool]
        n = burst * page_bytes
        reps = 9 if burst <= 64 else 3
        t = {
            "page_out": ev_ms(lambda: pops.copy_pages(
                twin, ids, pool, ids, name="page_out"), reps),
            "page_in": ev_ms(lambda: pops.copy_pages(
                scratch, None, twin, ids, name="page_in"), reps),
            "copy_d2h": ev_ms(lambda: host[:n].copy_(dev[:n],
                                                     non_blocking=True), reps),
            "copy_h2d": ev_ms(lambda: dev[:n].copy_(host[:n],
                                                    non_blocking=True), reps),
            "plain_out": ev_ms(lambda: pops.copy_pages(
                twin, ids, pool, ids, name="page_out", impl="reference"),
                min(reps, 3)),
            "plain_in": ev_ms(lambda: pops.copy_pages(
                scratch, None, twin, ids, name="page_in", impl="reference"),
                min(reps, 3)),
        }
        torch.cuda.synchronize()
        ok = all(torch.equal(sc, p[:, ids.long()])
                 for sc, p in zip(scratch, pool))
        gbs = {k: n / (v * 1e-3) / 1e9 for k, v in t.items()}
        rows.append(dict(burst=burst, bytes=n, ms=t, gb_s=gbs))
        print(f"  burst {burst:4d} pages ({n / 1e6:9.3f} MB): page_out "
              f"{gbs['page_out']:6.2f} GB/s ({t['page_out']:.4f} ms), "
              f"page_in {gbs['page_in']:6.2f} GB/s ({t['page_in']:.4f} ms), "
              f"copy_ D2H {gbs['copy_d2h']:6.2f} / H2D {gbs['copy_h2d']:6.2f}"
              f" GB/s, plain index_select+copy out {gbs['plain_out']:6.2f} /"
              f" in {gbs['plain_in']:6.2f} GB/s; share of "
              f"{link / 1e9:.0f} GB/s: out {gbs['page_out'] * 1e9 / link:.3f}"
              f" in {gbs['page_in'] * 1e9 / link:.3f}; page_in == pool: "
              f"{ok}")
        assert ok, burst
    print("  substrate streams JSON " + json.dumps(rows))
    del pool, twin, host, dev, scratch
    torch.cuda.empty_cache()

    base = EngineConfig(n_slots=8, max_seq=256, prefill_buckets=(64, 128),
                        page_tokens=16, pool_dtype="int8",
                        local_budget_frac=0.25)
    cfg = cut_depth(cfg)
    params = M.init_model(cfg, torch.Generator("cuda").manual_seed(0))
    print(f"substrate engine {cfg.name} ({cfg.num_layers}L, published "
          f"widths): the engine phase's trace with "
          f"local_budget_frac={base.local_budget_frac}")

    def serve(substrate):
        eng = ServingEngine.build(
            cfg, dataclasses.replace(base, substrate=substrate),
            params=params)
        gaps = watch_substrate(eng)
        reqs = make_scenario("chat", 16, cfg.vocab_size, seed=0,
                             prompt_buckets=(64, 128), gen_range=(16, 32),
                             arrival_rate=1e5)
        torch.cuda.synchronize()
        kernels.reset_counters()
        stats = eng.run(reqs)
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        plain = {k: v for k, v in kernels.REFERENCE_CALLS.items() if v}
        s = stats.summary()
        assert stats.n_requests == len(reqs) and not plain, plain
        print(f"  substrate={substrate:4s} requests={s['n_requests']} "
              f"tokens={s['tokens']} steps={s['steps']} wall_s="
              f"{stats.wall_s:.3f} tok_per_s_wall={s['tok_per_s_wall']:.1f}"
              f" remote_share={s['remote_share']:.4f} evictions="
              f"{stats.pager['evictions']} promotions="
              f"{stats.pager['promotions']} launches={launches}")
        print(f"    {substrate_line(eng, stats, gaps)}")
        return reqs, stats, launches, eng, gaps

    reqs, stats, launches, eng, gaps = serve("auto")
    oreqs, _, _, _, _ = serve("off")
    assert eng.substrate.mode == "physical", eng.substrate.mode
    assert gaps and all(g == 0 for g in gaps), gaps
    assert launches.get("page_out", 0) > 0, launches
    assert launches.get("page_in", 0) > 0, launches
    assert launches["write_pages"] == len(reqs), launches
    same = [a.output == b.output for a, b in zip(reqs, oreqs)]
    print(f"  tokens with the substrate on == off: {sum(same)} of "
          f"{len(same)} requests (gate: all)")
    assert all(same), same
    return {"page_out": launches["page_out"], "page_in": launches["page_in"]}

PREFETCH_MODES = (None, "demand", "stream", "ghb")
# the prefetch phase's spin before layer 0: 0.25 s at the H100's 1.98 GHz
# SM clock, while the host queues a layer of the scan in about 2 ms
STALL_CYCLES = 500_000_000
SNAP_ROWS = 8        # rows of each pooled leaf the spun scan copies out


def prefetch_phase(torch, timer):
    """The paper's two case studies on the card (`repro_torch.prefetch`,
    `repro_torch.sched`). (a) `scan_with_prefetch` over SmolLM-360M's 32
    layers at published widths (seeded random weights, bf16), the FFN
    leaves (w_gate, w_up, w_down: 3 x 960 x 2560, 14.7 MB a layer, 472
    MB in all) pool-resident in pinned host memory and copied one layer
    ahead by the page-copy kernel on a side stream (`layer_in`), the
    body the forward layer on 8 x 256 tokens: bit-equal to
    `blocks.stack_apply` with every leaf on the card; a scan whose body
    only copies rows of each layer's pooled leaves out to pinned host
    memory, with the main stream spun before layer 0 so that the host
    queues later layers' copies and bodies first, bit-equal to the
    leaves (a copy overwriting a buffer still to be read breaks it); one
    `layer_in` launch per layer, one layer's kernel copy equal to the plain
    `copy_pages`; the copy's ms a layer against its bound and `copy_`, a
    layer's compute ms and the coverage min(1, compute / transfer).
    (b) The bucket int8 cell of the engine phase with `substrate="auto"`,
    `local_budget_frac=0.25`, `cold_touch=0.1` on 8 chat requests, for
    `prefetch` in (None, "demand", "stream", "ghb"): the tokens equal
    across the four runs (staging never touches the math), `stream`'s
    demand share below `demand`'s, every pool byte demand or staged;
    issued, useful and excess bytes and virtual TPOT per predictor.
    (c) The stream run's `measured_profile()` through
    `sched.workload.serving_stream` and `simulate` under fcfs, random and
    aware (the reference test's assertions; arrivals one per 50 of the
    profile's steps, so the jobs co-reside at this step time), and the
    BFS frontier predictor's remote-access reduction on `bfs_trace` (the
    paper's first case study). Returns the `layer_in` launches of (a)'s
    run and its record."""
    import numpy as np

    from repro_torch import configs, kernels
    from repro_torch.kernels.page_io import ops as pops
    from repro_torch.models import blocks as blk
    from repro_torch.models import model as M
    from repro_torch.models.module import cast_params, layer_slice
    from repro_torch.prefetch import engine as pfe
    from repro_torch.prefetch import static
    from repro_torch.prefetch.workloads import bfs_trace
    from repro_torch.sched import build_cluster, make_policy, simulate
    from repro_torch.sched.workload import serving_stream
    from repro_torch.serving import EngineConfig, ServingEngine, \
        make_scenario

    cfg = configs.get("smollm_360m")              # bf16 activations
    L, d = cfg.num_layers, cfg.d_model
    params = M.init_model(cfg, torch.Generator("cuda").manual_seed(0))

    # --- (a) the layer loop with the FFN leaves in pinned host memory ---
    stack = cast_params(params["blocks"], cfg.dtype)
    layers = stack["pos0"]
    desc = blk.pattern(cfg)[0]
    pooled = sorted(layers["mlp"])
    host = dict(layers, mlp={
        k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True).copy_(v)
        for k, v in layers["mlp"].items()})
    def falses(tree):
        return ({k: falses(v) for k, v in tree.items()}
                if isinstance(tree, dict) else False)

    mask = dict(falses(layers), mlp={k: True for k in pooled})
    per_layer = sum(v[0].numel() * v.element_size()
                    for v in host["mlp"].values())
    gen = torch.Generator("cuda").manual_seed(1)
    x = torch.randn((8, 256, d), generator=gen, device="cuda").to(
        torch.bfloat16)

    def body(h, p):
        return blk._apply_layer_train(p, h, cfg, desc)[0], None

    print(f"prefetch (a) {cfg.name}: scan_with_prefetch over {L} layers, "
          f"{'/'.join(pooled)} pinned host ({per_layer / 1e6:.1f} MB a "
          f"layer, {L * per_layer / 1e6:.0f} MB), body the forward layer "
          f"on {tuple(x.shape[:2])} tokens")
    with torch.no_grad():
        want, _ = blk.stack_apply(stack, x, cfg)
        torch.cuda.synchronize()
        kernels.reset_counters()
        got, outs = static.scan_with_prefetch(body, x, host, mask, L)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        plain = {k: v for k, v in kernels.REFERENCE_CALLS.items() if v}
        print(f"  launches { {k: v for k, v in launches.items() if v}}; "
              f"plain calls {plain}")
        assert outs is None and not plain, plain
        assert launches["layer_in"] == L, launches      # one per layer
        same = torch.equal(got, want)
        print(f"  scan_with_prefetch == stack_apply (every leaf on the "
              f"card), bit for bit: {same}; max |diff| "
              f"{float((got.float() - want.float()).abs().max()):.3e}")
        assert same

        # the waits, with the card held back: a scan whose body only
        # copies the first and last SNAP_ROWS rows of its layer's pooled
        # leaves out to pinned host memory, the main stream spun before
        # layer 0 so that the host queues the next layers' copies and
        # bodies first. A copy that did not wait for the body that last
        # read its buffer would overwrite layer 0's leaves before layer 0
        # reads them, and the rows would differ. (A body that did not wait
        # for its copy would read the buffer early only where its read
        # slipped in ahead of the copy: on the H100 the main stream's
        # reads ran after the concurrent layer_in kernel, which fills
        # every SM, in every run checked, so this gate does not catch it.)
        stall_end = torch.cuda.Event()
        stalled = []         # per layer: queued while the card was spinning
        r = SNAP_ROWS
        snaps = {k: torch.empty((L, 2, r) + host["mlp"][k].shape[2:],
                                dtype=torch.bfloat16, pin_memory=True)
                 for k in pooled}

        def snapshot(h, p):
            if not stalled:
                torch.cuda._sleep(STALL_CYCLES)
                stall_end.record()
            i = len(stalled)
            stalled.append(not stall_end.query())
            for k in pooled:
                snaps[k][i, 0].copy_(p["mlp"][k][:r], non_blocking=True)
                snaps[k][i, 1].copy_(p["mlp"][k][-r:], non_blocking=True)
            return h, None

        static.scan_with_prefetch(snapshot, x, host, mask, L)
        torch.cuda.synchronize()
        same = all(torch.equal(snaps[k][:, 0], host["mlp"][k][:, :r])
                   and torch.equal(snaps[k][:, 1], host["mlp"][k][:, -r:])
                   for k in pooled)
        print(f"  a scan copying each layer's leaves' first and last {r} "
              f"rows out, the main stream spun {STALL_CYCLES:.0e} cycles "
              f"before layer 0: {sum(stalled[1:])} of {L - 1} later layers "
              f"queued during the spin (gate >= 2); every layer's rows == "
              f"its leaves', bit for bit: {same}")
        assert sum(stalled[1:]) >= 2 and same
        del snaps

        # one layer through the kernel and through the plain version
        ids = torch.arange(L, dtype=torch.int32, device="cuda")
        src = [host["mlp"][k][None] for k in pooled]
        i = L // 2
        bufs = {impl: [torch.full(host["mlp"][k].shape[1:], float("nan"),
                                  dtype=torch.bfloat16, device="cuda")
                       for k in pooled] for impl in ("cuda", "reference")}
        for impl, b in bufs.items():
            pops.copy_pages([t[None, None] for t in b], None, src,
                            ids[i:i + 1], name="layer_in", impl=impl)
        torch.cuda.synchronize()
        ok = all(torch.equal(a, b) and torch.equal(a, layers["mlp"][k][i])
                 for k, a, b in zip(pooled, bufs["cuda"], bufs["reference"]))
        print(f"  layer {i}'s copy, kernel == plain copy_pages == the "
              f"card's leaves: {ok}")
        assert ok

        buf = bufs["cuda"]
        dst = [t[None, None] for t in buf]
        hbuf = torch.empty(per_layer, dtype=torch.uint8, pin_memory=True)
        dbuf = torch.empty(per_layer, dtype=torch.uint8, device="cuda")
        copy_ms = timer(lambda: pops.copy_pages(
            dst, None, src, ids[i:i + 1], name="layer_in"))
        copy_ev = timer.last_event_ms
        plain_ms = timer.event_ms(lambda: pops.copy_pages(
            dst, None, src, ids[i:i + 1], name="layer_in", impl="reference"))
        lib_ms = timer.event_ms(lambda: dbuf.copy_(hbuf, non_blocking=True))
        on_card = layer_slice(layers, i)
        comp_ms = timer(lambda: body(x, on_card))
        comp_ev = timer.last_event_ms
        scan_ms = timer.event_ms(
            lambda: static.scan_with_prefetch(body, x, host, mask, L))
        stack_ms = timer.event_ms(lambda: blk.stack_apply(stack, x, cfg))
    bound = max(per_layer / HBM_BYTES_PER_S, per_layer / 64e9) * 1e3
    print(f"  layer_in {per_layer / 1e6:.2f} MB a layer: kernel "
          f"{copy_ms:.4f} ms device ({copy_ev:.4f} ms events; "
          f"{per_layer / copy_ms / 1e6:.1f} GB/s), bound {bound:.4f} ms "
          f"(64 GB/s), plain copy_pages {plain_ms:.4f} ms, copy_ of the "
          f"same bytes {lib_ms:.4f} ms")
    print(f"  a layer's compute: {comp_ms:.4f} ms device, {comp_ev:.4f} ms "
          f"events; coverage min(1, compute / transfer): device "
          f"{min(1.0, comp_ms / copy_ms):.3f}, events "
          f"{min(1.0, comp_ev / copy_ev):.3f}; {L} layers: scan "
          f"{scan_ms:.2f} ms, stack_apply (every leaf on the card) "
          f"{stack_ms:.2f} ms (events)")
    record = dict(
        name="layer_in", route="cuda",
        source="src/repro_torch/kernels/csrc/page_io.cu",
        replaces="src/repro/prefetch/static.py:35", max_abs_err=0.0,
        ms=copy_ms, op_ms=copy_ev, plain_ms=plain_ms, bound_ms=bound,
        bound_by="bytes", library_ms=lib_ms,
        shape=f"smollm-360m layer {i}: {'/'.join(pooled)} "
              f"({per_layer} B) from pinned host")
    del host, src, hbuf, dbuf, bufs, buf, dst, stack, layers
    torch.cuda.empty_cache()

    # --- (b) the bucket int8 cell with prediction-driven page-in --------
    base = EngineConfig(n_slots=8, max_seq=256, prefill_buckets=(64, 128),
                        page_tokens=16, pool_dtype="int8", substrate="auto",
                        local_budget_frac=0.25, cold_touch=0.1)
    print(f"prefetch (b) the bucket int8 cell, substrate auto, "
          f"local_budget_frac={base.local_budget_frac} "
          f"cold_touch={base.cold_touch}, 8 chat requests")
    runs = {}
    for mode in PREFETCH_MODES:
        eng = ServingEngine.build(
            cfg, dataclasses.replace(base, prefetch=mode), params=params)
        gaps = watch_substrate(eng)
        reqs = make_scenario("chat", 8, cfg.vocab_size, seed=0,
                             prompt_buckets=(64, 128), gen_range=(16, 32),
                             arrival_rate=1e5)
        torch.cuda.synchronize()
        kernels.reset_counters()
        stats = eng.run(reqs)
        torch.cuda.synchronize()
        eng_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        plain = {k: v for k, v in kernels.REFERENCE_CALLS.items() if v}
        s, c = stats.summary(), stats.pager
        excess = (c["prefetch_issued"] - c["prefetch_useful"]) \
            * eng.pager.page_bytes
        print(f"  prefetch={str(mode):6s} tokens={s['tokens']} steps="
              f"{s['steps']} demand_share={s['demand_share']:.4f} "
              f"remote_share={s['remote_share']:.4f} issued="
              f"{c['prefetch_issued']} useful={c['prefetch_useful']} "
              f"issued_bytes={c['prefetch_issued'] * eng.pager.page_bytes:.0f} "
              f"excess_bytes={excess:.0f} "
              f"demand_pool_bytes={c['demand_pool_bytes']:.0f} "
              f"prefetch_pool_bytes={c['prefetch_pool_bytes']:.0f} "
              f"virtual tpot_p50={s['tpot_p50_s'] * 1e6:.3f} us "
              f"tpot_p99={s['tpot_p99_s'] * 1e6:.3f} us virtual_s="
              f"{stats.virtual_s:.6f} wall tok/s={s['tok_per_s_wall']:.1f}"
              f" launches={eng_launches}")
        print(f"    {substrate_line(eng, stats, gaps)}")
        assert stats.n_requests == len(reqs) and not plain, plain
        assert eng.substrate.mode == "physical", eng.substrate.mode
        assert gaps and all(g == 0 for g in gaps), gaps
        assert all(eng_launches.get(k, 0) > 0 for k in BUCKET_KERNELS), \
            eng_launches
        split = c["demand_pool_bytes"] + c["prefetch_pool_bytes"]
        assert abs(split - c["pool_bytes"]) <= 1e-9 * c["pool_bytes"], c
        runs[mode] = (reqs, stats, eng)
    toks = {m: [r.output for r in reqs] for m, (reqs, _, _) in runs.items()}
    same = all(toks[m] == toks[None] for m in PREFETCH_MODES)
    print(f"  tokens equal across prefetch {list(PREFETCH_MODES)}: {same}")
    assert same
    share = {m: runs[m][1].pager["demand_share"] for m in ("demand",
                                                           "stream")}
    print(f"  demand_share stream {share['stream']:.4f} < demand "
          f"{share['demand']:.4f}: {share['stream'] < share['demand']}")
    assert share["stream"] < share["demand"], share

    # --- (c) the scheduler on the engine's measured profile -------------
    prof = runs["stream"][2].measured_profile()
    step0 = prof.step_time(0.0)
    print(f"prefetch (c) measured profile of the stream run: pool "
          f"{prof.pool_traffic:.0f} B/step, local {prof.local_traffic:.0f} "
          f"B/step, t_compute {prof.t_compute * 1e6:.3f} us, step "
          f"{step0 * 1e6:.3f} us, injected LoI {prof.injected_loi():.4f}, "
          f"IC {prof.interference_coefficient():.4f}")
    assert prof.pool_traffic >= 0 and prof.t_compute > 0
    assert 0.0 <= prof.injected_loi() <= 1.0
    jobs = serving_stream(12, prof, seed=0, arrival_rate=1.0 / (50 * step0),
                          steps=(200, 400))
    assert all(abs(j.injected_loi - prof.injected_loi()) <= 1e-12
               for j in jobs)
    # the reference test's cluster (one pool of 4 slots: the policies
    # cannot differ there), then 2 racks x 2 pools x 2 slots
    for shape in ((1, 1, 4), (2, 2, 2)):
        for name in ("fcfs", "random", "aware"):
            res = simulate(jobs, build_cluster(*shape), make_policy(name))
            sd = res.slowdown
            print(f"  {name:6s} 12 serving jobs, racks x pools x slots "
                  f"{shape}: slowdown mean {float(sd.mean()):.6f} var "
                  f"{float(sd.var()):.3e} max {float(sd.max()):.6f}, mean "
                  f"wait {float(res.wait.mean()) / step0:.1f} steps")
            assert np.all(res.finish >= res.start)
            if shape == (1, 1, 4) and prof.injected_loi() > 0.05:
                # loud co-residents stretch each other (reference test)
                assert float(sd.max()) > 1.0, name
    t0 = time.perf_counter()
    t = bfs_trace(n_vertices=8192, avg_degree=16, page_bytes=1024,
                  chunk=32).trace
    rep = pfe.evaluate_zoo(
        t, pfe.PrefetchConfig(local_pages=max(8, t.n_pages // 16),
                              bw_pages_per_step=40, degree=40),
        predictors=["demand", "next_line", "stream", "frontier"])
    by = {r.predictor: r for r in rep}
    print(f"  BFS case study (host numpy, {time.perf_counter() - t0:.1f} s):"
          f" remote-access reduction frontier "
          f"{pfe.remote_reduction(rep, 'frontier'):.3f}, next_line "
          f"{pfe.remote_reduction(rep, 'next_line'):.3f}, stream "
          f"{pfe.remote_reduction(rep, 'stream'):.3f}; speedup "
          f"{by['demand'].total_time / by['frontier'].total_time - 1:.3f}")
    return {"layer_in": launches["layer_in"]}, record


def fleet_phase(torch):
    """Faults and the fleet at SmolLM-360M's published widths (depth cut
    to DEPTH's 8 of 32 layers), on the card,
    no plain version anywhere (the engine phase's configuration and
    16-request chat trace, with local_budget_frac=0.25 so pages move
    between the tiers, unless said):
      1. parity: 2 engines behind the round-robin `FleetRouter` against one
         engine, fp (tokens equal) and int8 (agreement >= 0.5, exactness
         printed), both engines routed work;
      2. chaos: `chaos_smoke` (engine 1 killed at decode step 3, transfers
         flaking at 10%) against the same fleet fault-free, fp: tokens
         equal; retries, restores, migrations and re-prefilled tokens
         > 0; every pool drained free (zero refcounts and pins); the
         placement gap 0 after every drain of every engine, the dead one
         included;
      3. roles: engine 0 prefill (`prefill_chunk=128`) and engine 1 decode
         against the unified 2-engine fleet of the same cells, on 8
         requests of 128-token prompts, fp (tokens equal) and int8
         (agreement): one handoff launch per request, the transfer
         ledger's pages and bytes, the chunk kernel of the pool launched
         on engine 0 only;
      4. preemption (the reference test's shape, fp, 2 slots of 64 tokens
         in 16-token pages): with pages stranded under a pin, a
         priority-0 prompt spill-freezes the priority-1 slot, which
         resumes by refill; both streams equal their uncontended run and
         the pool drains exactly free;
      5. one pinned `freeze_slot` -> drain -> `thaw_slot` at decode step
         10 and `degrade_pool` at step 20 of the fp chat run: page_out
         and page_in launched, gap 0 after every drain, tokens equal the
         uninterrupted single-engine run of part 1;
      6. the handoff stream at 8 and 64 pages against its byte bound and
         its plain version.
    Prints tok/s and launches of each run. Returns the handoff's launches
    in the int8 roles run."""
    import numpy as np

    from repro_torch import configs, kernels
    from repro_torch.models import model as M
    from repro_torch.serving import (INT8_TOKEN_AGREEMENT, EngineConfig,
                                     Request, RequestQueue, ServingEngine,
                                     make_plan, make_scenario)
    from repro_torch.serving.fleet import FleetConfig, FleetRouter

    import dev_serve_torch as dst

    cfg = cut_depth(configs.get("smollm_360m"))
    # the local tier cut to a quarter of peak KV, as in the substrate
    # phase: pages spill to the pool tier and return in every engine, so
    # the transfer sites the plan flakes see traffic
    base = EngineConfig(n_slots=8, max_seq=256, prefill_buckets=(64, 128),
                        page_tokens=16, pool_dtype="fp",
                        local_budget_frac=0.25)
    params = M.init_model(cfg, torch.Generator("cuda").manual_seed(0))
    print(f"fleet {cfg.name}: {cfg.num_layers}L d={cfg.d_model}, random "
          f"weights seed 0, engines share one parameter tree and one set "
          f"of cells; substrate auto, local_budget_frac "
          f"{base.local_budget_frac}")

    def chat(n=16, buckets=(64, 128)):
        return make_scenario("chat", n, cfg.vocab_size, seed=0,
                             prompt_buckets=buckets, gen_range=(16, 32),
                             arrival_rate=1e5)

    replay = {"tokens": 0, "decode_launches": 0, "s": 0.0}

    def watch_replay(eng):
        """Count the teacher-forced replay's tokens, decode launches and
        wall seconds (`_force_feed`) into `replay`."""
        feed = eng._force_feed

        def counted(slot, start, toks):
            n0 = kernels.LAUNCHES["paged_flash_decode"]
            t0 = time.perf_counter()
            feed(slot, start, toks)
            torch.cuda.synchronize()
            replay["s"] += time.perf_counter() - t0
            replay["tokens"] += len(toks)
            replay["decode_launches"] += (
                kernels.LAUNCHES["paged_flash_decode"] - n0)

        eng._force_feed = counted

    def serve(label, reqs, ecfg, fcfg=None, drive=None):
        """One run of `reqs` on a fresh engine (fcfg None) or fleet;
        `drive(eng, reqs)` replaces `eng.run`. Returns (stats, engines,
        launches, router); every drain's placement gap must be 0."""
        if fcfg is None:
            engines = [ServingEngine.build(cfg, ecfg, params=params)]
            router = None
        else:
            router = FleetRouter.build(cfg, ecfg, fcfg, params=params)
            engines = [h.engine for h in router.handles]
        gaps = [watch_substrate(e) for e in engines]
        for e in engines:
            watch_replay(e)
        torch.cuda.synchronize()
        kernels.reset_counters()
        t0 = time.perf_counter()
        if router is not None:
            stats = router.run(reqs)
        elif drive is not None:
            stats = drive(engines[0], reqs)
        else:
            stats = engines[0].run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        plain = {k: v for k, v in kernels.REFERENCE_CALLS.items() if v}
        tokens = sum(len(r.output) for r in reqs)
        print(f"  {label}: requests={len(reqs)} tokens={tokens} "
              f"wall_s={wall:.3f} tok_per_s_wall={tokens / wall:.1f} "
              f"launches={launches}")
        for i, (e, g) in enumerate(zip(engines, gaps)):
            assert e.substrate is not None \
                and e.substrate.mode == "physical", i
            assert all(x == 0 for x in g), (label, i, g)
        assert not plain, plain
        assert all(len(r.output) == r.max_new_tokens for r in reqs), label
        return stats, engines, launches, router

    def compare(label, got, want, exact):
        agree = [agreement(a.output, b.output) for a, b in zip(got, want)]
        same = sum(a.output == b.output for a, b in zip(got, want))
        print(f"  {label}: {same} of {len(got)} requests equal, agreement "
              f"min {min(agree):.3f} (gate: "
              f"{'all equal' if exact else f'>= {INT8_TOKEN_AGREEMENT}'})")
        if exact:
            assert same == len(got), label
        else:
            assert min(agree) >= INT8_TOKEN_AGREEMENT, agree

    # --- 1. fleet parity ----------------------------------------------
    rr = FleetConfig(n_engines=2, policy="round_robin")
    runs = {}
    for pool in ("fp", "int8"):
        ecfg = dataclasses.replace(base, pool_dtype=pool)
        single = chat()
        serve(f"single {pool}", single, ecfg)
        fleet = chat()
        stats, _, _, _ = serve(f"fleet 2 round-robin {pool}", fleet, ecfg,
                               rr)
        print(f"    routed {stats.routed}")
        assert min(stats.routed) > 0, stats.routed
        assert stats.faults == {}
        compare(f"fleet vs single, {pool}", fleet, single,
                exact=pool == "fp")
        runs[pool] = (single, fleet)

    # --- 2. chaos -----------------------------------------------------
    plan = make_plan("chaos_smoke")
    chaos = chat()
    replay.update(tokens=0, decode_launches=0, s=0.0)
    stats, engines, launches, router = serve(
        "fleet 2 chaos_smoke fp", chaos, base,
        dataclasses.replace(rr, faults=plan))
    f = stats.faults
    print(f"    faults: killed={f['engines_killed']} recoveries="
          f"{f['recoveries']} retries={f['retries']} retry_bytes="
          f"{f['retry_bytes']:.0f} backoff_s={f['backoff_s']:.6f} "
          f"restores={f['restores']} migrations_in={f['migrations_in']} "
          f"reprefilled_tokens={f['reprefilled_tokens']} injected="
          f"{f['injected']}; routed {stats.routed}; teacher-forced replay "
          f"{replay['tokens']} tokens, {replay['decode_launches']} "
          f"paged_flash_decode launches, {replay['s']:.3f} s")
    compare("chaos vs fault-free fleet, fp", chaos, runs["fp"][1],
            exact=True)
    assert router.handles[1].dead and f["engines_killed"] == 1
    assert f["retries"] > 0 and f["restores"] > 0
    assert f["migrations_in"] > 0 and f["reprefilled_tokens"] > 0
    assert dst.pools_drained(router), "a pool did not drain free"
    assert all(g == 0 for g in dst.placement_gaps(router))

    # --- 3. roles -------------------------------------------------------
    roles_launches = None
    for pool in ("fp", "int8"):
        ecfg = dataclasses.replace(base, pool_dtype=pool,
                                   prefill_chunk=128, prefill_buckets=(128,))
        unified = chat(8, (128,))
        serve(f"fleet 2 unified chunk=128 {pool}", unified, ecfg, rr)
        split = chat(8, (128,))
        stats, engines, launches, router = serve(
            f"fleet 2 roles chunk=128 {pool}", split, ecfg,
            FleetConfig(n_engines=2, roles=True))
        t = stats.transfers
        print(f"    transfer ledger: transfers={t['transfers']} pages="
              f"{t['pages']} bytes={t['bytes']:.0f} mean_latency_s="
              f"{t['mean_latency_s']:.3e}; routed {stats.routed}")
        compare(f"roles vs unified, {pool}", split, unified,
                exact=pool == "fp")
        chunk_kernel = ("paged_prefill_insert_flash_q8" if pool == "int8"
                        else "paged_prefill_insert_flash")
        assert t["transfers"] == len(split) == launches["handoff"], launches
        assert stats.routed == [len(split), 0], stats.routed
        assert launches[chunk_kernel] == cfg.num_layers * len(split)
        assert dst.pools_drained(router)
        if pool == "int8":
            roles_launches = launches["handoff"]

    # --- 4. preemption -------------------------------------------------
    pcfg = EngineConfig(n_slots=2, max_seq=64, prefill_buckets=(32, 48),
                        page_tokens=16, pool_dtype="fp", admission="greedy")
    rng = np.random.default_rng(21)
    tok_b = rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
    tok_c = rng.integers(0, cfg.vocab_size, 48).astype(np.int32)
    ref_b = Request(request_id=0, tokens=tok_b, max_new_tokens=24)
    ref_c = Request(request_id=1, tokens=tok_c, max_new_tokens=16)
    serve("preemption: uncontended", [ref_b, ref_c], pcfg)
    b = Request(request_id=0, tokens=tok_b, max_new_tokens=24, priority=1)
    c = Request(request_id=1, tokens=tok_c, max_new_tokens=16, priority=0)

    def contend(eng, reqs):
        sac = Request(request_id=7, tokens=tok_b.copy(), max_new_tokens=24,
                      priority=1)
        eng.run([sac], max_steps=2)
        slot = next(s for s in eng.batcher.slots if s.active)
        held = eng.pager.phys[slot.index, eng.pager.valid[slot.index]]
        assert held.size == 3, held
        eng.pager.pin(held)
        eng._retire(slot)
        eng.run([b], max_steps=4)
        assert eng.pager.counters()["free_pages"] < 3
        stats = eng.run([c])
        eng.pager.unpin(held)
        eng.substrate.drain(eng.pager, eng.caches, step=eng.steps)
        p = eng.pager
        assert sorted(p._free_phys) == list(range(p.n_phys))
        assert (p.ref == 0).all() and p.pins == 0 and not eng.frozen
        return stats

    stats, _, _, _ = serve("preemption: contended", [b, c], pcfg,
                           drive=contend)
    f = stats.faults
    print(f"    faults: preempts={f['preempts']} spills={f['spills']} "
          f"restores={f['restores']} reprefilled_tokens="
          f"{f['reprefilled_tokens']}")
    assert f["preempts"] >= 1 and f["spills"] >= 1 and f["restores"] >= 1
    compare("preempted streams vs uncontended, fp", [b, c], [ref_b, ref_c],
            exact=True)

    # --- 5. pinned freeze -> drain -> thaw, then degrade_pool ----------
    moved = {}

    def freeze_and_degrade(eng, reqs):
        q = RequestQueue(reqs)
        cap = eng.begin_capture()
        while len(q) or eng.batcher.n_busy:
            act = eng.pump(q)
            if act == "idle":
                eng.advance_to(q.next_arrival())
            if act != "decode":
                continue
            if eng.steps == 10:
                victim = max((s for s in eng.batcher.slots if s.active),
                             key=lambda s: s.seq)
                fs = eng.freeze_slot(victim)
                out0 = kernels.LAUNCHES["page_out"]
                pages0 = eng.substrate.counters()["page_out_pages"]
                eng.substrate.drain(eng.pager, eng.caches, step=eng.steps)
                moved["frozen_pages"] = len(fs.pages)
                moved["page_out_launches"] = (kernels.LAUNCHES["page_out"]
                                              - out0)
                moved["pages_out"] = (eng.substrate.counters()[
                    "page_out_pages"] - pages0)
                assert set(fs.pages.tolist()) <= eng.substrate._resident
                assert eng.thaw_slot(eng.frozen.pop(0))
            elif eng.steps == 20:
                in0 = kernels.LAUNCHES["page_in"]
                eng.degrade_pool()
                eng.substrate.drain(eng.pager, eng.caches, step=eng.steps)
                moved["degrade_page_in_launches"] = (
                    kernels.LAUNCHES["page_in"] - in0)
                assert eng.pager.pool_bytes_used() == 0.0
        return eng.capture_stats(cap, reqs)

    fr = chat()
    stats, _, launches, _ = serve("freeze/thaw/degrade fp", fr, base,
                                  drive=freeze_and_degrade)
    s_ = stats.substrate
    print(f"    {moved}; page_out {s_['page_out_pages']} pages, page_in "
          f"{s_['page_in_pages']} pages; faults preempts="
          f"{stats.faults['preempts']} restores={stats.faults['restores']}"
          f" degraded={stats.faults['degraded']}")
    assert moved["page_out_launches"] == 1 and moved["pages_out"] > 0
    assert moved["degrade_page_in_launches"] == 1
    assert launches["page_out"] > 0 and launches["page_in"] > 0
    compare("freeze/thaw/degrade vs uninterrupted, fp", fr, runs["fp"][0],
            exact=True)

    # --- 6. the handoff stream alone ------------------------------------
    timer = Timer(torch)
    gen = torch.Generator("cuda").manual_seed(3)
    for n in (8, 64):
        t = handoff_times(torch, timer, gen, n)
        print(f"  handoff {n:2d} pages ({t['bytes'] / 1e6:.3f} MB): "
              f"{t['ms']:.4f} ms device ({t['op_ms']:.4f} events), bound "
              f"{t['bound_ms']:.5f} ms (2 x bytes / 3.35 TB/s, "
              f"{t['bound_ms'] / t['ms']:.2f} of it), plain "
              f"{t['plain_ms']:.4f} ms")
    return {"handoff": roles_launches}


def chunked_phase(torch):
    """Serve SmolLM-360M's shared-prefix trace with chunked prefill and
    the prefix cache (int8, then fp pools), each against the same trace
    on the plain versions; then drive the chunk cell of a per-token int8
    pool directly. Returns the launches of each chunked-prefill kernel
    in its own path's run."""
    from repro_torch import configs, kernels
    from repro_torch.models import model as M
    from repro_torch.models.module import cast_params
    from repro_torch.runtime import serve as serve_rt
    from repro_torch.serving import (INT8_TOKEN_AGREEMENT, EngineConfig,
                                     ServingEngine, make_scenario)

    cfg = configs.get("smollm_360m")              # bf16 activations
    base = EngineConfig(n_slots=8, max_seq=544, prefill_buckets=(256, 512),
                        page_tokens=16, pool_dtype="int8", prefill_chunk=128,
                        prefix_cache=True)
    params = M.init_model(cfg, torch.Generator("cuda").manual_seed(0))
    print(f"chunked {cfg.name}: prefill_chunk={base.prefill_chunk} "
          f"prefix_cache=True n_slots={base.n_slots} "
          f"max_seq={base.max_seq} page={base.page_tokens}; shared_prefix "
          "trace of 16 requests, system prompt 128 tokens, prompts "
          "256/512, 16-32 new tokens")

    # 16 requests: two waves of the 8 slots, so the second wave's
    # admissions find the first wave's prefixes in the cache
    def serve(backend, profiled=False, n_req=16, **over):
        kernels.force_backend(backend)
        try:
            ecfg = dataclasses.replace(base, **over)
            eng = ServingEngine.build(cfg, ecfg, params=params)
            reqs = make_scenario("shared_prefix", n_req, cfg.vocab_size,
                                 seed=0, system_tokens=128,
                                 prompt_buckets=(256, 512),
                                 gen_range=(16, 32), arrival_rate=1e5)
            peak = [0]
            step = eng.pager.step

            def counted_step(active, *a, **k):
                # distinct pages the live slots map (trie-only pages are
                # reclaimable copies and not counted)
                pg = eng.pager
                peak[0] = max(peak[0], len(set(pg.phys[pg.valid].tolist())))
                return step(active, *a, **k)

            eng.pager.step = counted_step
            assert eng.substrate.mode == "physical", eng.substrate.mode
            gaps = watch_substrate(eng)
            torch.cuda.synchronize()
            kernels.reset_counters()
            if profiled:
                return profile_run(torch, eng, reqs,
                                   "chunked int8 prefix kernels run")
            stats = eng.run(reqs)
            launches = dict(kernels.LAUNCHES)
            plain = dict(kernels.REFERENCE_CALLS)
        finally:
            kernels.force_backend(None)
        assert stats.n_requests == len(reqs)
        for r in reqs:
            assert len(r.output) == r.max_new_tokens, r.request_id
        s = stats.summary()
        print(f"  pool={ecfg.pool_dtype:4s} prefix={ecfg.prefix_cache!s:5s} "
              f"backend={backend or 'kernels':9s} requests="
              f"{s['n_requests']} tokens={s['tokens']} steps={s['steps']} "
              f"wall_s={stats.wall_s:.3f} tok_per_s_wall="
              f"{s['tok_per_s_wall']:.1f} prefix_hits="
              f"{stats.prefix.get('hits')} shared_mapped_pages="
              f"{stats.pager['shared_mapped_pages']} peak_slot_pages="
              f"{peak[0]} of {eng.pager.n_phys} "
              f"launches={ {k: v for k, v in launches.items() if v} } "
              f"plain_calls={ {k: v for k, v in plain.items() if v} }")
        print(f"    {substrate_line(eng, stats, gaps)}")
        assert all(g == 0 for g in gaps), gaps
        if ecfg.prefix_cache:
            # the second wave's admissions map the first wave's prefixes
            assert stats.prefix.get("hits", 0) > 0 \
                and stats.pager["shared_mapped_pages"] > 0, \
                (stats.prefix, stats.pager["shared_mapped_pages"])
        return reqs, launches, plain

    out = {}
    for pool, kernel in (("int8", "paged_prefill_insert_flash_q8"),
                         ("fp", "paged_prefill_insert_flash")):
        kreqs, launches, plain = serve(None, pool_dtype=pool)
        assert launches[kernel] > 0 and launches["paged_flash_decode"] > 0, \
            launches
        assert not any(plain.values()), plain
        out[kernel] = launches[kernel]
        rreqs, rlaunch, _ = serve("reference", pool_dtype=pool)
        assert not any(rlaunch.values()), rlaunch
        agree = [agreement(a.output, b.output) for a, b in zip(kreqs, rreqs)]
        print(f"  pool={pool}: per-request token agreement kernels vs "
              f"plain: min={min(agree):.3f} mean="
              f"{sum(agree) / len(agree):.3f} (gate >= "
              f"{INT8_TOKEN_AGREEMENT})")
        assert min(agree) >= INT8_TOKEN_AGREEMENT, agree
    # no profiled run here (printed only, cut for the script's time):
    # the engine phase's profiles the bucket path

    # the per-token int8 pool reaches the engine only with speculation
    # (ROADMAP A8): drive its chunk cell over one 512-token prompt
    cells = serve_rt.make_engine_cells(
        cfg, n_slots=2, max_seq=544, buckets=(512,), page_tokens=16,
        prefill_chunk=128, pool_dtype="int8", sz_granularity="token")
    sparams = cast_params(params, cfg.dtype)
    gen = torch.Generator("cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (1, 512), generator=gen,
                         device="cuda", dtype=torch.int32)
    bt = torch.zeros((2, cells.n_pages), dtype=torch.int32, device="cuda")
    bt[0] = torch.randperm(2 * cells.n_pages, generator=gen,
                           device="cuda")[:cells.n_pages].to(torch.int32)
    runs = {}
    for backend in (None, "reference"):
        kernels.force_backend(backend)
        try:
            caches = M.make_paged_decode_caches(
                cfg, 2, cells.max_seq_total, 16, pool_dtype="int8",
                sz_granularity="token", device="cuda")
            torch.cuda.synchronize()
            kernels.reset_counters()
            picks = [int(cells.chunk_fn(sparams, toks[:, i * 128:(i + 1) * 128],
                                        caches, 0, i, bt)[0][0])
                     for i in range(4)]
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            plain = dict(kernels.REFERENCE_CALLS)
            # the final chunk again through the cell's body for its logits
            # (the per-token scatter rewrites the same values)
            logits, _ = M.prefill_chunk(sparams, toks[:, 384:], caches, 3,
                                        cfg, bt[0:1], 16)
        finally:
            kernels.force_backend(None)
        runs[backend] = (picks, logits.float(), caches, launches, plain)
    (kp, kl, kc, kla, kpl), (rp, rl, rc, rla, rpl) = runs[None], \
        runs["reference"]
    assert kla["paged_prefill_flash"] == 4 * cfg.num_layers, kla
    assert not any(kpl.values()) and not any(rla.values()), (kpl, rla)
    out["paged_prefill_flash"] = kla["paged_prefill_flash"]
    logit_err = float((kl - rl).abs().max())
    logit_tol = 0.05 * float(rl.abs().max())
    # pools: dequantize every layer's written pages and compare (the
    # chunks' K/V come from two attention implementations, so the int8
    # grids may differ by one step where a value sits on a boundary)
    pages = bt[0].long()
    pool_err = pool_max = 0.0
    for key in ("k", "v"):
        a, b = (c["pos0"][key][:, pages].float()
                * c["pos0"][key + "_sz"][:, pages][..., 0:1]
                + c["pos0"][key + "_sz"][:, pages][..., 1:2]
                for c in (kc, rc))
        pool_err = max(pool_err, float((a - b).abs().max()))
        pool_max = max(pool_max, float(b.abs().max()))
    print(f"  per-token int8 chunk cell, 512-token prompt in 4 chunks: "
          f"launches paged_prefill_flash={kla['paged_prefill_flash']}; "
          f"picks kernels {kp} plain {rp}; last-chunk logits max_abs_err "
          f"{logit_err:.4f} (tol {logit_tol:.4f} = 5% of max |logit|); "
          f"dequantized pools max_abs_err {pool_err:.4f} (max |K/V| "
          f"{pool_max:.3f})")
    assert agreement(kp, rp) >= INT8_TOKEN_AGREEMENT, (kp, rp)
    assert logit_err <= logit_tol, (logit_err, logit_tol)
    assert pool_err <= 0.05 * pool_max, (pool_err, pool_max)
    return out


def chat_prompts(cfg, n=8, length=128, gen=32):
    """The prompts of the contiguous and speculative phases: `n` chat
    requests of `length` tokens (seed 0), served all at once."""
    from repro_torch.serving import make_scenario

    reqs = make_scenario("chat", n, cfg.vocab_size, seed=0,
                         prompt_buckets=(length,), gen_range=(gen, gen))
    return [r.tokens for r in reqs]


def pair_line(name, c) -> str:
    return (f"{name}: exact={c['exact']} min={c['min']:.3f} "
            f"mean={c['mean']:.3f} first_divergence={c['first_divergence']}")


def contiguous_phase(torch):
    """SmolLM-360M, bf16, on the contiguous layout (`paged=False`,
    n_slots=8, max_seq=256, one bucket of 128): 8 prompts of 128 tokens,
    32 new tokens each, through the contiguous engine (flash_decode), the
    paged fp engine, the naive one-shot loop and the contiguous engine on
    the plain versions; every pair agrees >= INT8_TOKEN_AGREEMENT.
    Returns flash_decode's launches in the contiguous engine run."""
    import dev_serve_torch as dst
    from repro_torch import configs, kernels
    from repro_torch.models import model as M
    from repro_torch.serving import INT8_TOKEN_AGREEMENT

    cfg = configs.get("smollm_360m")
    params = M.init_model(cfg, torch.Generator("cuda").manual_seed(0))
    prompts = chat_prompts(cfg)
    gen, max_seq = 32, 256
    print(f"contiguous {cfg.name}: paged=False n_slots=8 max_seq={max_seq} "
          f"bucket 128; {len(prompts)} chat prompts of 128 tokens, {gen} "
          "new tokens each")

    def run(label, backend, fn):
        kernels.force_backend(backend)
        try:
            torch.cuda.synchronize()
            kernels.reset_counters()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
            plain = {k: v for k, v in kernels.REFERENCE_CALLS.items() if v}
        finally:
            kernels.force_backend(None)
        toks = out[0] if isinstance(out, tuple) else out
        tok_s = (out[1].summary()["tok_per_s_wall"] if isinstance(out, tuple)
                 else toks.size / wall)
        print(f"  {label:26s} tokens={toks.size} wall_s={wall:.3f} "
              f"tok_per_s_wall={tok_s:.1f} launches={launches} "
              f"plain_calls={plain}")
        return toks, launches, plain

    def engine(paged, **kw):
        return lambda: dst.engine_greedy(
            cfg, params, prompts, gen, paged=paged, max_seq=max_seq,
            page_tokens=16, pool_dtype="fp", device="cuda", **kw)[:2]

    contig, launches, plain = run("contiguous engine", None, engine(False))
    assert launches.get("flash_decode", 0) > 0 and not plain, (launches,
                                                               plain)
    assert "paged_flash_decode" not in launches, launches
    paged, pl, pp = run("paged fp engine", None, engine(True))
    assert pl.get("paged_flash_decode", 0) > 0 and not pp, (pl, pp)
    naive, nl, np_ = run("naive loop", None, lambda: dst.naive_greedy(
        cfg, params, prompts, gen, max_seq=max_seq, device="cuda"))
    assert nl.get("flash_decode", 0) > 0 and not np_, (nl, np_)
    ref, rl, _ = run("contiguous engine, plain", "reference", engine(False))
    assert not rl, rl
    for name, a, b in (("contiguous vs paged fp", contig, paged),
                       ("contiguous vs naive loop", contig, naive),
                       ("paged fp vs naive loop", paged, naive),
                       ("contiguous kernels vs plain", contig, ref)):
        c = dst.compare(a, b)
        print(f"  {pair_line(name, c)} (gate min >= "
              f"{INT8_TOKEN_AGREEMENT})")
        assert c["min"] >= INT8_TOKEN_AGREEMENT, (name, c)
    return {"flash_decode": launches["flash_decode"]}


SPEC_KERNELS = ("paged_flash_decode", "paged_prefill_flash", "flash_decode")


def speculative_phase(torch):
    """SmolLM-360M, bf16, speculative decoding (k=4) on the paged engine
    (n_slots=8, max_seq=256, bucket 128) over the contiguous phase's
    prompts: ngram on fp pools with bucket prefill, ngram on int8 pools
    with prefill_chunk=128 (per-token sub-scales: paged_prefill_flash
    inside the engine), and the self-draft (flash_decode on the draft's
    contiguous caches) on fp; each against the greedy engine of the same
    pool, agreement >= INT8_TOKEN_AGREEMENT per request (for int8 the
    greedy run on the same per-token pool; against the per-page greedy
    run, the reference's gate on the mean over all tokens). Returns
    paged_prefill_flash's launches in the int8 run."""
    import dev_serve_torch as dst
    from repro_torch import configs, kernels
    from repro_torch.models import model as M
    from repro_torch.serving import INT8_TOKEN_AGREEMENT

    cfg = configs.get("smollm_360m")
    params = M.init_model(cfg, torch.Generator("cuda").manual_seed(0))
    prompts = chat_prompts(cfg)
    gen, k = 32, 4
    print(f"speculative {cfg.name}: k={k} n_slots=8 max_seq=256 bucket "
          f"128; {len(prompts)} chat prompts of 128 tokens, {gen} new "
          "tokens each")

    def serve(**kw):
        torch.cuda.synchronize()
        kernels.reset_counters()
        toks, stats, eng = dst.engine_greedy(
            cfg, params, prompts, gen, paged=True, max_seq=256,
            page_tokens=16, device="cuda", **kw)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        plain = {n: v for n, v in kernels.REFERENCE_CALLS.items() if v}
        assert not plain, plain
        return toks, stats, eng, launches

    # greedy baselines: fp; int8 on the engine's default per-page pool;
    # int8 on the per-token pool speculation selects (the same pool as
    # the speculative int8 run, so only speculation differs)
    greedy = {}
    for pool, gran in (("fp", None), ("int8", None), ("int8", "token")):
        chunk = 128 if pool == "int8" else None
        toks, stats, eng, launches = serve(pool_dtype=pool,
                                           prefill_chunk=chunk,
                                           sz_granularity=gran)
        greedy[pool, eng.cells.sz_granularity] = toks
        assert eng.substrate.mode == "physical", eng.substrate.mode
        print(f"  greedy pool={pool} sz={eng.cells.sz_granularity} "
              f"prefill_chunk={chunk}: steps={stats.steps} tok_per_s_wall="
              f"{stats.summary()['tok_per_s_wall']:.1f} launches="
              f"{ {n: v for n, v in launches.items() if v} }")
    out = {}
    for mode, pool, chunk in (("ngram", "fp", None), ("ngram", "int8", 128),
                              ("draft", "fp", None)):
        toks, stats, eng, launches = serve(
            pool_dtype=pool, prefill_chunk=chunk, speculative=mode,
            speculative_k=k)
        assert eng.substrate.mode == "physical", eng.substrate.mode
        sp = stats.spec
        c = dst.compare(toks, greedy[pool, eng.cells.sz_granularity])
        print(f"  {mode} pool={pool} prefill_chunk={chunk} sz="
              f"{eng.cells.sz_granularity} substrate={eng.substrate.mode}: "
              "verify_steps="
              f"{sp['verify_steps']} emitted={sp['emitted']} "
              f"accept_len_mean={sp['accept_len_mean']:.3f} draft_calls="
              f"{sp['draft_calls']} tok_per_s_wall="
              f"{stats.summary()['tok_per_s_wall']:.1f} launches="
              f"{ {n: launches[n] for n in SPEC_KERNELS} }")
        print(f"    {pair_line('vs greedy, same pool', c)} (gate min >= "
              f"{INT8_TOKEN_AGREEMENT})")
        if pool == "int8":
            # against the per-page greedy run the quantization grid
            # differs too; the reference gates this pair on the mean over
            # all tokens (tests/test_serving.py,
            # test_engine_speculative_int8_token_scales)
            cp = dst.compare(toks, greedy["int8", "page"])
            print(f"    {pair_line('vs greedy, per-page pool', cp)} (gate "
                  f"mean >= {INT8_TOKEN_AGREEMENT}, the reference's)")
            assert cp["mean"] >= INT8_TOKEN_AGREEMENT, (mode, pool, cp)
        assert launches["paged_flash_decode"] > 0, launches
        if chunk:
            assert launches["paged_prefill_flash"] > 0, launches
            out["paged_prefill_flash"] = launches["paged_prefill_flash"]
        if mode == "draft":
            assert launches["flash_decode"] > 0 and sp["draft_calls"] > 0
        assert sp["emitted"] == len(prompts) * (gen - 1), sp
        assert c["min"] >= INT8_TOKEN_AGREEMENT, (mode, pool, c)
    return out


def ssm_phase(torch):
    """mamba2-780m at published widths (d 1536, 48 heads of dim 64, state
    128; its 48 SSM layers cut to DEPTH's 16; seeded random bf16 weights)
    served by
    `ServingEngine` on the engine phase's configuration (paged int8,
    n_slots=8, max_seq=256, buckets 64/128, 16-token pages) over its
    16-request chat trace: every request finishes, ssd_scan launches once
    a layer per admission and no plain version runs (no bf16 run on the
    plain versions: printed only, cut for the script's time);
    in float32 (fp pools) the kernel and plain runs agree per request >=
    INT8_TOKEN_AGREEMENT; the teacher-forced prompt pass of every request
    moves the last-token logits, kernels against plain, no further in
    bf16 than bf16 itself moves them off float32, and within 2e-3 in
    float32. Then 8 chat prompts of
    128 tokens, 32 new
    tokens each: the paged int8, paged fp and contiguous engines each
    emit the naive loop's tokens bit for bit. Last, in float32, a prefill
    of 64 tokens and 8 decode steps against a prefill of all 72: the
    last-token logits within 2e-3 (the reference's state-carry gate),
    which holds the kernel's final state against the decode recurrence.
    Returns ssd_scan's launches in the int8 engine run."""
    import dev_serve_torch as dst
    from repro_torch import configs, kernels
    from repro_torch.models import model as M
    from repro_torch.models.module import cast_params
    from repro_torch.serving import (INT8_TOKEN_AGREEMENT, EngineConfig,
                                     ServingEngine, make_scenario)

    cfg = cut_depth(configs.get("mamba2_780m"))
    assert cfg.dtype == "bfloat16"
    base = EngineConfig(n_slots=8, max_seq=256, prefill_buckets=(64, 128),
                        page_tokens=16, pool_dtype="int8")
    params = M.init_model(cfg, torch.Generator("cuda").manual_seed(0))
    print(f"ssm {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"d_inner={cfg.d_inner} heads={cfg.ssm_heads}x{cfg.ssm_head_dim} "
          f"state={cfg.ssm_state} conv={cfg.conv_width} "
          f"vocab={cfg.vocab_size}, random weights seed 0")

    failures = []

    def gate(ok, what):
        if not ok:
            print(f"  FAIL {what}")
            failures.append(what)

    def serve(backend, profiled=False, model=None, n_req=16, **over):
        cfg_, params_ = model or (cfg, params)
        kernels.force_backend(backend)
        try:
            eng = ServingEngine.build(cfg_, dataclasses.replace(base, **over),
                                      params=params_)
            reqs = make_scenario("chat", n_req, cfg.vocab_size, seed=0,
                                 prompt_buckets=(64, 128),
                                 gen_range=(16, 32), arrival_rate=1e5)
            torch.cuda.synchronize()
            kernels.reset_counters()
            if profiled:
                return profile_run(torch, eng, reqs, "mamba2 int8 run")
            stats = eng.run(reqs)
            torch.cuda.synchronize()
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
            plain = {k: v for k, v in kernels.REFERENCE_CALLS.items() if v}
        finally:
            kernels.force_backend(None)
        assert stats.n_requests == len(reqs)
        for r in reqs:
            assert len(r.output) == r.max_new_tokens, r.request_id
        s = stats.summary()
        print(f"  {cfg_.dtype} pool={eng.cells.pool_dtype:4s} backend="
              f"{backend or 'kernels':9s} requests={s['n_requests']} "
              f"tokens={s['tokens']} steps={s['steps']} "
              f"wall_s={stats.wall_s:.3f} "
              f"tok_per_s_wall={s['tok_per_s_wall']:.1f} "
              f"max_concurrency={s['max_concurrency']} resident_MB_per_slot="
              f"{eng.pager.resident_bytes / 1e6:.1f} launches={launches} "
              f"plain_calls={plain} substrate="
              f"{'disabled' if eng.substrate is None else 'ON'}")
        # SSM-only stack: no paged leaves, so no substrate under "auto"
        assert eng.substrate is None
        return reqs, launches, plain

    kreqs, launches, plain = serve(None)
    want = cfg.num_layers * len(kreqs)
    print(f"  ssd_scan launches {launches.get('ssd_scan', 0)} == "
          f"{cfg.num_layers} layers x {len(kreqs)} admissions = {want}")
    assert launches.get("ssd_scan", 0) == want, launches
    assert not plain, plain
    # (c) the gate runs in float32: the random-weight 48-layer stack
    # amplifies bf16 rounding (one bf16 ulp in some elements of a layer's
    # y) into logit drifts that flip near-tied greedy tokens, for any two
    # float32 summation orders alike, so bf16 lockstep agreement measures
    # the model's chaos, not the kernel
    m32 = (dataclasses.replace(cfg, dtype="float32"),
           cast_params(params, "float32"))
    k32, _, _ = serve(None, model=m32, pool_dtype="fp")
    r32, _, _ = serve("reference", model=m32, pool_dtype="fp")
    a32 = [agreement(a.output, b.output) for a, b in zip(k32, r32)]
    print(f"  float32, fp pools: per-request token agreement kernels vs "
          f"plain: min={min(a32):.3f} mean={sum(a32) / len(a32):.3f} (gate "
          f">= {INT8_TOKEN_AGREEMENT})")
    gate(min(a32) >= INT8_TOKEN_AGREEMENT,
         f"float32 kernels vs plain agreement {a32}")
    # teacher-forced prompt pass of every request: last-token logits of
    # the kernel and plain runs in bf16 and float32; the kernel may move
    # bf16 logits no further than bf16 itself moves them off float32
    p16 = cast_params(params, cfg.dtype)
    runs = {}
    for dt_name, (c_, p_) in (("bf16", (cfg, p16)), ("f32", m32)):
        for backend in (None, "reference"):
            kernels.force_backend(backend)
            try:
                runs[dt_name, backend] = torch.stack([
                    M.prefill(p_, {"tokens": torch.as_tensor(
                        r.tokens[None, :], device="cuda")}, c_,
                        max_seq=r.prompt_len)[1][0].float() for r in kreqs])
            finally:
                kernels.force_backend(None)

    def drift(a, b):
        return float((runs[a] - runs[b]).abs().max())

    d_kernel16 = drift(("bf16", None), ("bf16", "reference"))
    d_dtype = drift(("bf16", "reference"), ("f32", "reference"))
    d_kernel32 = drift(("f32", None), ("f32", "reference"))
    flips = int((runs["bf16", None].argmax(-1)
                 != runs["bf16", "reference"].argmax(-1)).sum())
    print(f"  prompt pass, last-token logits max_abs_err over {len(kreqs)} "
          f"prompts (max |logit| "
          f"{float(runs['f32', 'reference'].abs().max()):.3f}): kernels vs "
          f"plain in bf16 {d_kernel16:.4f} ({flips} first tokens differ), "
          f"plain bf16 vs plain float32 {d_dtype:.4f}, kernels vs plain in "
          f"float32 {d_kernel32:.3e} (gates: bf16 drift <= the dtype's; "
          "float32 <= 2e-3)")
    gate(d_kernel16 <= d_dtype, f"bf16 kernel drift {d_kernel16} > bf16 "
         f"dtype drift {d_dtype}")
    gate(d_kernel32 <= 2e-3, f"float32 kernel drift {d_kernel32}")
    # no profiled run here (printed only, cut for the script's time):
    # the engine phase's profiles the serving loop

    # (b) engine == naive loop, bit for bit, in each layout and pool
    prompts = chat_prompts(cfg)
    gen, max_seq = 32, 256
    t0 = time.perf_counter()
    naive = dst.naive_greedy(cfg, params, prompts, gen, max_seq=max_seq,
                             device="cuda")
    torch.cuda.synchronize()
    print(f"  naive loop: {len(prompts)} prompts of 128 tokens, {gen} new "
          f"tokens each, {naive.size / (time.perf_counter() - t0):.1f} "
          "tok/s wall")
    for label, kw in (("paged int8", dict(paged=True, pool_dtype="int8")),
                      ("paged fp", dict(paged=True, pool_dtype="fp")),
                      ("contiguous", dict(paged=False, pool_dtype="fp"))):
        kernels.reset_counters()
        toks, stats, _ = dst.engine_greedy(
            cfg, params, prompts, gen, max_seq=max_seq, page_tokens=16,
            device="cuda", **kw)
        c = dst.compare(toks, naive)
        print(f"  {pair_line(label + ' engine vs naive loop', c)} "
              f"tok_per_s_wall={stats.summary()['tok_per_s_wall']:.1f} "
              f"ssd_scan={kernels.LAUNCHES['ssd_scan']} (gate: exact)")
        assert kernels.LAUNCHES["ssd_scan"] == cfg.num_layers * len(prompts)
        gate(c["exact"], f"{label} engine vs naive loop {c}")

    # (d) the kernel's final state against the decode recurrence, float32
    cfg32, p32 = m32
    toks = torch.stack([torch.as_tensor(p[:72]) for p in prompts[:2]]).to(
        "cuda")
    kernels.reset_counters()
    caches, _ = M.prefill(p32, {"tokens": toks[:, :64]}, cfg32, max_seq=72)
    for t in range(64, 72):
        logits, caches = M.decode_step(p32, toks[:, t], caches, t, cfg32)
    _, full = M.prefill(p32, {"tokens": toks}, cfg32, max_seq=72)
    torch.cuda.synchronize()
    err = float((logits - full).abs().max())
    print(f"  continuation f32: prefill 64 + 8 decode steps vs prefill 72: "
          f"last-token logits max_abs_err {err:.3e} (max |logit| "
          f"{float(full.abs().max()):.3f}; gate 2e-3); ssd_scan "
          f"launches {kernels.LAUNCHES['ssd_scan']}")
    assert kernels.LAUNCHES["ssd_scan"] == 2 * cfg.num_layers
    gate(err <= 2e-3, f"continuation max_abs_err {err}")
    if failures:
        raise AssertionError(f"ssm phase: {failures}")
    return {"ssd_scan": launches["ssd_scan"]}


class RouteTape:
    """Stands in for `models.moe.top_k` (the library's own is `top_k`)
    during a prompt pass: records the router's top-k picks and the
    margin p[k-1] - p[k] of every call in order, or, given another run's
    picks, returns those (with this run's probs at them), so a kernel run
    can be held against the plain run on the plain run's routing. A
    routing near-tie flips under any reordering of the float32 sums, and
    the top k is a step function of them."""

    def __init__(self, top_k, replay=None):
        self.top_k = top_k
        self.replay = replay
        self.picks, self.margins = [], []

    def __call__(self, probs, k):
        vals, idx = self.top_k(probs, k + 1)
        self.margins.append(vals[..., k - 1] - vals[..., k])
        vals, idx = vals[..., :k], idx[..., :k]
        if self.replay is not None:
            idx = self.replay[len(self.picks)]
            vals = probs.gather(-1, idx)
        self.picks.append(idx)
        return vals, idx

    @property
    def n_tokens(self) -> int:
        return sum(p.shape[0] for p in self.picks)

    def flips(self, other, n_req: int) -> dict:
        """Where this run's top-k sets differ from `other`'s, the calls
        being `n_req` prompt passes of equally many router layers in
        order: `n` sets of `n_tokens`, `other`'s margins among them
        (`low`, `high`; 0 if none) and `first`, the largest margin among
        the sets of each pass's first layer that differs (a later
        layer's flip may follow from it: the hidden states then differ
        by an expert's share)."""
        per = len(self.picks) // n_req
        n, low, high, first = 0, float("inf"), 0.0, 0.0
        for i, (a, b, m) in enumerate(zip(self.picks, other.picks,
                                          other.margins)):
            if i % per == 0:
                seen = False
            differ = (a.sort(-1).values != b.sort(-1).values).any(-1)
            if not differ.any():
                continue
            n += int(differ.sum())
            low = min(low, float(m[differ].min()))
            high = max(high, float(m[differ].max()))
            if not seen:
                first = max(first, float(m[differ].max()))
                seen = True
        return dict(n=n, n_tokens=self.n_tokens,
                    low=low if n else 0.0, high=high, first=first)


# the archs phase's float32 routing gate: where a prompt pass's top-k
# sets first differ kernels vs plain, each flipped set was a near-tie of
# the plain run (p[k-1] - p[k] at most ROUTE_NEAR_TIE; 1.79e-7 read on
# granite-moe-1b-a400m, NVIDIA H100 80GB HBM3, 700 W), and few sets flip
# in all (12 of 21504 read there); a later layer's flips follow from the
# first and are printed
ROUTE_NEAR_TIE = 1e-6
ROUTE_FLIP_SHARE = 1e-2

# the archs phase: (arch, prompt buckets); the enc-dec arch has the one
# bucket the reference demands, and its frames have that many rows
ARCHS = (("granite_moe_1b_a400m", (64, 128)),
         ("paligemma_3b", (64, 128)),
         ("seamless_m4t_large_v2", (128,)))


def archs_phase(torch):
    """The rest of the catalog at published widths (depth cut to DEPTH's:
    8, 6 and 8 + 8 layers; seeded random bf16 weights made on the card):
    granite-moe-1b-a400m (24L, d 1024, 16/8 heads, 32 experts top 8,
    expert ff 512),
    paligemma-3b (18L, d 2048, 8/1 heads of dim 256, ff 16384, 256 patch
    embeddings before the prompt) and seamless-m4t-large-v2 (24 + 24L, d
    1024, 16/16 heads, ff 8192, 128 frames), each served by
    `ServingEngine` with `EngineConfig(n_slots=8, page_tokens=16)`, the
    int8 pool and max_seq 256 (the vision prefix comes on top) over 8 chat
    requests (prompts 64/128, or 128 for seamless; 16-32 new tokens).
    Gates: (a) every request finishes, the kernel run launches flash_mha,
    paged_flash_decode and one page copy per admission (flash_decode too
    for seamless's cross-attention) and no plain version runs; in float32
    the kernel and plain runs (`force_backend("reference")`) agree per
    request >= INT8_TOKEN_AGREEMENT; the
    teacher-forced prompt pass moves the last-token logits, kernels
    against plain, no further in bf16 than bf16 itself moves them off
    float32, and within 2e-3 in float32 on the plain run's routing,
    where the routing first differs only at near-ties (`ROUTE_NEAR_TIE`);
    (b) on an fp pool the engine emits the naive loop's tokens bit for
    bit (8 prompts of 128 tokens, 32 new tokens, the engine's frontend
    embeddings, each prompt prefilled alone as the engine admits it; the
    batched prefill's loop, printed only, was cut for the script's time:
    cuBLAS picks another algorithm for 8 prompts' rows than for 1,
    ROADMAP C); (c) a
    profiled run of the kernel
    engine shows those kernels by name. Prints wall tok/s, decode steps,
    launches and peak device memory per arch. Returns the launches of
    the three int8 kernel runs, summed."""
    import dev_serve_torch as dst
    from repro_torch import configs, kernels
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.module import cast_params
    from repro_torch.serving import (INT8_TOKEN_AGREEMENT, EngineConfig,
                                     ServingEngine, make_scenario)
    from repro_torch.serving.engine import frontend_extras

    print(f"archs on {smi_line()}")
    failures = []
    total: dict = {}

    def gate(ok, what):
        if not ok:
            print(f"  FAIL {what}")
            failures.append(what)

    for arch, buckets in ARCHS:
        t_arch = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = cut_depth(configs.get(arch))
        assert cfg.dtype == "bfloat16"
        params = M.init_model(cfg, torch.Generator("cuda").manual_seed(0))
        base = EngineConfig(n_slots=8, max_seq=256, prefill_buckets=buckets,
                            page_tokens=16, pool_dtype="int8")
        want = ("flash_mha", "paged_flash_decode", "write_pages") + (
            ("flash_decode",) if cfg.num_encoder_layers else ())
        print(f"archs {cfg.name}: {cfg.num_layers}L"
              f"{f' + {cfg.num_encoder_layers}L encoder' if cfg.num_encoder_layers else ''}"
              f" d={cfg.d_model} H={cfg.num_heads}/{cfg.num_kv_heads} "
              f"hd={cfg.head_dim} ff={cfg.d_ff or cfg.moe_d_ff} experts="
              f"{cfg.num_experts}/{cfg.experts_per_token} prefix="
              f"{cfg.num_prefix_tokens if cfg.frontend == 'vision_stub' else 0}"
              f" vocab={cfg.vocab_size}, random weights seed 0, "
              f"{cfg.param_count() / 1e9:.2f}B params, buckets {buckets}")

        def serve(backend, model=None, profiled=False):
            cfg_, params_ = model or (cfg, params)
            kernels.force_backend(backend)
            try:
                eng = ServingEngine.build(cfg_, base, params=params_)
                reqs = make_scenario("chat", 8, cfg.vocab_size, seed=0,
                                     prompt_buckets=buckets,
                                     gen_range=(16, 32), arrival_rate=1e5)
                torch.cuda.synchronize()
                kernels.reset_counters()
                if profiled:
                    return profile_run(torch, eng, reqs[:2],
                                       f"{arch} int8 kernels run")
                stats = eng.run(reqs)
                torch.cuda.synchronize()
                launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
                plain = {k: v for k, v in kernels.REFERENCE_CALLS.items()
                         if v}
            finally:
                kernels.force_backend(None)
            assert stats.n_requests == len(reqs)
            for r in reqs:
                assert len(r.output) == r.max_new_tokens, r.request_id
            s = stats.summary()
            print(f"  {cfg_.dtype} pool=int8 backend="
                  f"{backend or 'kernels':9s} requests={s['n_requests']} "
                  f"tokens={s['tokens']} decode_steps={s['steps']} "
                  f"wall_s={stats.wall_s:.3f} tok_per_s_wall="
                  f"{s['tok_per_s_wall']:.1f} max_concurrency="
                  f"{s['max_concurrency']} launches={launches} "
                  f"plain_calls={plain}")
            return reqs, launches, plain

        # (a) the kernel run, its plain run, and the float32 pair
        kreqs, launches, plain = serve(None)
        gate(all(launches.get(k, 0) > 0 for k in want)
             and launches["write_pages"] == len(kreqs) and not plain,
             f"{arch} kernel run launches {launches} plain {plain}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        # the bf16 plain engine run (its agreement was printed, never
        # gated) is cut for time; the float32 pair below is the gate
        m32 = (dataclasses.replace(cfg, dtype="float32"),
               cast_params(params, "float32"))
        k32, _, _ = serve(None, model=m32)
        r32, _, _ = serve("reference", model=m32)
        a32 = [agreement(a.output, b.output) for a, b in zip(k32, r32)]
        print(f"  float32: per-request token agreement kernels vs plain: "
              f"min={min(a32):.3f} mean={sum(a32) / len(a32):.3f} (gate >= "
              f"{INT8_TOKEN_AGREEMENT})")
        gate(min(a32) >= INT8_TOKEN_AGREEMENT,
             f"{arch} float32 kernels vs plain agreement {a32}")
        # teacher-forced prompt pass: last-token logits of each request;
        # the router's picks are taped (plain float32 run) and, for the
        # pinned run, replayed into the kernel run
        p16 = cast_params(params, cfg.dtype)
        runs, tapes = {}, {}
        top_k = moe_mod.top_k

        def prompt_pass(c_, p_, backend, tape):
            kernels.force_backend(backend)
            moe_mod.top_k = tape
            try:
                return torch.stack([M.prefill(
                    p_, {"tokens": torch.as_tensor(
                        r.tokens[None, :], device="cuda"),
                        **frontend_extras(c_, r.request_id, r.prompt_len,
                                          "cuda")},
                    c_, max_seq=r.prompt_len)[1][0].float() for r in kreqs])
            finally:
                kernels.force_backend(None)
                moe_mod.top_k = top_k

        for dt_name, (c_, p_) in (("bf16", (cfg, p16)), ("f32", m32)):
            for backend in (None, "reference"):
                tapes[dt_name, backend] = RouteTape(top_k)
                runs[dt_name, backend] = prompt_pass(
                    c_, p_, backend, tapes[dt_name, backend])
        plain32 = tapes["f32", "reference"]
        runs["pinned"] = (prompt_pass(*m32, None,
                                      RouteTape(top_k, plain32.picks))
                          if cfg.num_experts else runs["f32", None])

        def drift(a, b):
            return float((runs[a] - runs[b]).abs().max())

        d16 = drift(("bf16", None), ("bf16", "reference"))
        d_dtype = drift(("bf16", "reference"), ("f32", "reference"))
        d32 = drift(("f32", None), ("f32", "reference"))
        d32_pinned = drift("pinned", ("f32", "reference"))
        flips = tapes["f32", None].flips(plain32, len(kreqs))
        print(f"  prompt pass, last-token logits max_abs_err over "
              f"{len(kreqs)} prompts (max |logit| "
              f"{float(runs['f32', 'reference'].abs().max()):.3f}): kernels "
              f"vs plain in bf16 {d16:.4f}, plain bf16 vs plain float32 "
              f"{d_dtype:.4f}, kernels vs plain in float32 {d32:.3e}, "
              f"with the plain run's routing {d32_pinned:.3e} (gates: bf16 "
              "drift <= the dtype's; float32 with the routing pinned <= "
              "2e-3)")
        if cfg.num_experts:
            print(f"  float32 routing: {flips['n']} of {flips['n_tokens']} "
                  f"token-layer top-{cfg.experts_per_token} sets differ "
                  f"kernels vs plain; the plain margins p[k-1] - p[k] among "
                  f"them {flips['low']:.3e} to {flips['high']:.3e}, at each "
                  f"prompt's first differing layer <= {flips['first']:.3e} "
                  f"(gates: <= {ROUTE_NEAR_TIE:g} there, at most "
                  f"{ROUTE_FLIP_SHARE:g} of the sets)")
        gate(d16 <= d_dtype, f"{arch} bf16 kernel drift {d16} > {d_dtype}")
        gate(d32_pinned <= 2e-3,
             f"{arch} float32 kernel drift (routing pinned) {d32_pinned}")
        if cfg.num_experts:
            gate(flips["first"] <= ROUTE_NEAR_TIE
                 and flips["n"] <= ROUTE_FLIP_SHARE * flips["n_tokens"],
                 f"{arch} float32 routing flips {flips}")
        del runs, tapes, m32, p16

        # (b) the fp engine against the naive loop, bit for bit
        prompts = chat_prompts(cfg)
        gen, max_seq = 32, 256
        naive = dst.naive_greedy(cfg, params, prompts, gen, max_seq=max_seq,
                                 device="cuda", each=True)
        toks, stats, _ = dst.engine_greedy(
            cfg, params, prompts, gen, max_seq=max_seq, page_tokens=16,
            device="cuda", paged=True, pool_dtype="fp")
        c = dst.compare(toks, naive)
        print(f"  {pair_line('paged fp engine vs naive loop', c)} "
              f"tok_per_s_wall={stats.summary()['tok_per_s_wall']:.1f} "
              "(gate: exact; each prompt prefilled alone, as the engine "
              "admits it)")
        gate(c["exact"], f"{arch} engine vs naive loop {c}")

        # (c) the profiled kernel run names the kernels
        groups = serve(None, profiled=True)
        seen = [g for g in dict.fromkeys(
            {"write_pages": "write_pages/page_out/page_in"}.get(k, k)
            for k in want) if groups.get(g, 0) > 0]
        print(f"  profiled run: device kernels of {seen} found (gate: "
              f"{len(want)} groups)")
        gate(len(seen) == len(want), f"{arch} profiled groups {groups}")
        print(f"  {arch}: peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"{time.perf_counter() - t_arch:.1f} s")
        del params
    if failures:
        raise AssertionError(f"archs phase: {failures}")
    return total


# --------------------------------------------------------------- train
def bwd_kernel_split(torch, fn, reps: int = 5) -> dict:
    """Device ms per call of `fn` by kernel (short names), from a
    complete torch.profiler trace of `reps` calls (`profiled_kernels`;
    empty when none came out complete)."""
    fn()
    kern = profiled_kernels(torch, fn, reps)
    out: dict = {}
    for e in kern or ():
        name = short_names([e.name])[0]
        out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / reps / 1e3
    return out


def flash_bwd_cases(torch, timer) -> dict:
    """flash_mha's CUDA backward against its plain version (the chunked
    backward, `chunked._bwd_inner`) on the same (q, k, v, out, lse, dout)
    at the training shapes, float32 within 1e-4 of the largest grad, bf16
    within 2e-2 of it, two calls bit-equal; timed at smollm-360m's train
    shape (bf16, B 8, S 256) beside its bound, the plain version and
    SDPA's backward. Returns the kernel's JSON record (launches filled in
    by the caller)."""
    from repro_torch.kernels.flash_attention import chunked
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as fops

    F = torch.nn.functional
    gen = torch.Generator("cuda").manual_seed(5)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    cases = [
        # (label, B, Sq, Skv, H, KV, D, causal, kv_offset)
        ("smollm train", 8, 256, 256, 15, 5, 64, True, 0),
        ("smollm train", 8, 1024, 1024, 15, 5, 64, True, 0),
        ("seamless encoder", 8, 128, 128, 16, 16, 64, False, 0),
        ("paligemma", 2, 384, 384, 8, 1, 256, True, 0),
        ("D 20", 2, 100, 100, 3, 1, 20, True, 0),
        ("kv_offset", 2, 64, 128, 6, 2, 64, True, 64),
        ("qwen2.5 D 128", 1, 512, 512, 40, 8, 128, True, 0),
        # D 36 and D 40: rows of 24 and 6 copies (4 and 16 bytes), the
        # staging's general path, padded to 48 columns with zeros
        ("D 36", 1, 130, 130, 4, 2, 36, True, 0),
        ("D 40", 1, 130, 130, 4, 2, 40, True, 0),
    ]
    print("kernel flash_mha_bwd vs the plain backward on the same inputs "
          "(float32 max_abs_err <= 1e-4 x max|grad|, bf16 <= 2e-2 x "
          "max|grad|; two calls bit-equal; bf16 on the tensor cores, "
          "float32 on the FMA units)")
    failures = []
    main = None
    for label, B, Sq, Skv, H, KV, D, causal, off in cases:
        for dt in (torch.float32, torch.bfloat16):
            q = randn(B, Sq, H, D, dtype=dt)
            k = randn(B, Skv, KV, D, dtype=dt)
            v = randn(B, Skv, KV, D, dtype=dt, scale=0.5)
            do = randn(B, Sq, H, D, dtype=dt)
            out, lse4 = chunked._fwd(q, k, v, causal, None, off, 512, 512)
            lse = lse4.reshape(B, H, Sq).contiguous()
            args = (q, k, v, out, lse, do)
            got = fa.flash_mha_bwd_cuda(*args, causal=causal, kv_offset=off)
            again = fa.flash_mha_bwd_cuda(*args, causal=causal,
                                          kv_offset=off)
            want = chunked._bwd_inner(causal, None, off, 512, 512,
                                      (q, k, v, out, lse4), do)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            rel = 1e-4 if dt == torch.float32 else 2e-2
            errs = []
            ok = same
            for g, w in zip(got, want):
                scale_ = float(w.float().abs().max())
                err = float((g.float() - w.float()).abs().max())
                errs.append(err / max(scale_, 1e-30))
                ok = ok and err <= rel * scale_ and bool(
                    torch.isfinite(g).all())
            flag = "ok  " if ok else "FAIL"
            was = (" (the FMA body's bf16 err/max on these cases: 2.6e-4 "
                   "to 2.7e-3)" if dt == torch.bfloat16 else "")
            print(f"  {flag} flash_mha_bwd {label:16s} B={B} Sq={Sq} "
                  f"Skv={Skv} H={H} KV={KV} D={D} causal={causal} "
                  f"off={off} {str(dt)[6:]:8s} err/max dq {errs[0]:.2e} "
                  f"dk {errs[1]:.2e} dv {errs[2]:.2e} bit-equal={same}"
                  + was)
            if not ok:
                failures.append(f"{label} {dt}")
            if main is None and dt == torch.bfloat16:
                main = (args, causal, off, max(
                    float((g.float() - w.float()).abs().max())
                    for g, w in zip(got, want)))
    # no query rows against 64 keys: dq is empty and dk, dv are zeros (no
    # query sees a key); the grads' memory is handed out NaN-filled first
    for dt in (torch.float32, torch.bfloat16):
        for causal, off in ((False, 0), (True, 64)):
            q0, do0 = (randn(2, 0, 4, 64, dtype=dt) for _ in range(2))
            k0, v0 = (randn(2, 64, 2, 64, dtype=dt) for _ in range(2))
            lse0 = torch.zeros((2, 4, 0), device="cuda")
            junk = [torch.full_like(k0, math.nan) for _ in range(4)]
            del junk
            dq0, dk0, dv0 = fa.flash_mha_bwd_cuda(
                q0, k0, v0, torch.zeros_like(q0), lse0, do0, causal=causal,
                kv_offset=off)
            ok = dq0.numel() == 0 and not dk0.any() and not dv0.any()
            print(f"  {'ok  ' if ok else 'FAIL'} flash_mha_bwd no query rows "
                  f"Sq=0 Skv=64 causal={causal} off={off} "
                  f"{str(dt)[6:]}: dk, dv zero")
            if not ok:
                failures.append(f"Sq 0 {dt} causal={causal}")
    if failures:
        raise AssertionError(f"flash_mha_bwd cases failed: {failures}")

    (q, k, v, out, lse, do), causal, off, err = main
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    lse4 = lse.reshape(B, KV, H // KV, Sq)
    # kernel, plain version and SDPA's backward by one method: the device
    # time of complete profiler traces (`Timer`), else the queued CUDA
    # events of all three, which are printed in every run beside the
    # CUDA-events time around a call
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    try:
        o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                               enable_gqa=True)
        lib_fn = functools.partial(torch.autograd.grad, o_lib, (qt, kt, vt),
                                   do.transpose(1, 2), retain_graph=True)
    except (TypeError, RuntimeError) as e:   # torch without enable_gqa
        print(f"  SDPA backward not timed: {e}")
        lib_fn = None
    fns = [lambda: fa.flash_mha_bwd_cuda(q, k, v, out, lse, do,
                                         causal=causal, kv_offset=off),
           lambda: chunked._bwd_inner(causal, None, off, 512, 512,
                                      (q, k, v, out, lse4), do),
           lib_fn]
    clocks = [smi_clocks()]
    dev_ms, event_ms, queued = [], [], []
    for f in fns:
        if f is None:
            dev_ms.append(None)
            continue
        dev_ms.append(timer(f))
        event_ms.append(timer.last_event_ms)
        queued.append(timer.queued_ms(f))
        if len(clocks) == 1:
            clocks.append(smi_clocks())
    method = "torch.profiler" if timer.profiled else \
        "CUDA events behind a queued spin"
    ms, plain_ms, lib_ms = dev_ms if timer.profiled else \
        queued[:2] + [queued[2] if lib_fn is not None else None]
    split = bwd_kernel_split(torch, fns[0])
    print("  flash_mha_bwd device ms per call by kernel: " + (json.dumps(
        {k_: round(v_, 4) for k_, v_ in split.items()}) if split else
        "not measured (incomplete trace)")
        + f"; SM clock, power, temperature before / after the kernel's "
        f"timing: {clocks[0]} / {clocks[1]}")
    # q, out, dout and k, v read once, dq and dk, dv written once: the
    # formula the dry-run's flash_mha_bwd unit reads
    ops, nbytes = fops.mha_bwd_cost(q.shape, k.shape, causal=causal,
                                    kv_offset=off, itemsize=q.element_size())
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS["bfloat16"]
    bound_ms = max(t_bytes, t_ops) * 1e3
    print(f"  flash_mha_bwd at smollm-360m's train shape (bf16 causal B={B} "
          f"S={Sq} H={H} KV={KV} D={D}): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, SDPA backward "
          f"{'not timed' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
          f"{bound_ms:.4f} ms ({'bytes' if t_bytes >= t_ops else 'operations'}"
          f": {ops:.3e} operations, {nbytes} bytes); all three device "
          f"times from {method}; CUDA events behind a queued spin "
          "(kernel, plain, SDPA): " + ", ".join(f"{x:.4f}" for x in queued)
          + "; CUDA events around a call: "
          + ", ".join(f"{x:.4f}" for x in event_ms))
    return dict(
        name="flash_mha_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:146",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=lib_ms,
        shape=f"bf16 causal B={B} S={Sq} H={H} KV={KV} D={D}")


def train_run(torch, cfg, backend, steps, batch, seq, lr=1e-3,
              deterministic=False, state=None, start=0, save=None,
              shadow=False, witness=None):
    """`steps` train steps of `cfg` from `state` (default: the seed-0
    init on the card) over the synthetic batches of steps start.. start +
    steps, through the kernels (backend None) or the plain versions
    ("reference"). `save` (a CheckpointManager) saves the state after the
    last step. With `shadow`, the plain versions also take a step from
    the state each step starts from (its new state dropped; not timed,
    not counted) and its loss and grad norm are kept; with `witness` (a
    config), the plain versions take that config's step from the same
    state too. Returns a dict of losses, grad norms, the shadow and
    witness steps' (loss, grad norm), step ms,
    tokens/s, peak device memory over the timed steps, the launches, the
    plain calls and the final state."""
    from repro_torch import kernels
    from repro_torch.common.config import TrainConfig
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.runtime import train as train_rt

    tcfg = TrainConfig(learning_rate=lr, total_steps=12, warmup_steps=2)
    step_fn = train_rt.build_train_step(cfg, tcfg)
    witness_fn = (train_rt.build_train_step(witness, tcfg)
                  if witness is not None else None)
    batches = [{k: v.to("cuda") for k, v in make_batch_for(
        cfg, seq, batch, s).items()} for s in range(start, start + steps)]
    if state is None:
        state = train_rt.init_train_state(
            cfg, torch.Generator("cuda").manual_seed(0))
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    kernels.force_backend(backend)
    try:
        torch.cuda.synchronize()
        kernels.reset_counters()
        losses, gnorms, shadows, witnesses, ms, peak = [], [], [], [], [], 0
        for b in batches:
            if shadow:
                counts = (dict(kernels.LAUNCHES),
                          dict(kernels.REFERENCE_CALLS))
                kernels.force_backend("reference")
                _, sm = step_fn(state, b)
                shadows.append((float(sm["loss"]), float(sm["grad_norm"])))
                if witness_fn is not None:
                    _, sm = witness_fn(state, b)
                    witnesses.append((float(sm["loss"]),
                                      float(sm["grad_norm"])))
                del _, sm
                kernels.force_backend(backend)
                kernels.LAUNCHES.update(counts[0])
                kernels.REFERENCE_CALLS.update(counts[1])
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, b)
            losses.append(float(metrics["loss"]))    # synchronizes
            ms.append((time.perf_counter() - t0) * 1e3)
            gnorms.append(float(metrics["grad_norm"]))
            peak = max(peak, torch.cuda.max_memory_allocated())
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        plain = {k: v for k, v in kernels.REFERENCE_CALLS.items() if v}
    finally:
        kernels.force_backend(None)
        torch.use_deterministic_algorithms(prev)
    if save is not None:
        save.save(start + steps, state, blocking=True)
    med = statistics.median(ms[1:] if len(ms) > 1 else ms)
    return dict(losses=losses, gnorms=gnorms, shadows=shadows,
                witnesses=witnesses, step_ms=med, all_ms=ms,
                tok_s=batch * seq / med * 1e3, peak_gb=peak / 1e9,
                launches=launches, plain=plain, state=state)


def nudged_init(torch, cfg):
    """The seed-0 init with every float weight moved one float32 step
    up (`nextafter`, a relative change of 6e-8 to 1.2e-7)."""
    from repro_torch.optim.adamw import tree_map
    from repro_torch.runtime import train as train_rt

    state = train_rt.init_train_state(
        cfg, torch.Generator("cuda").manual_seed(0))
    inf = torch.tensor(math.inf, device="cuda")
    state["params"] = tree_map(
        lambda p: torch.nextafter(p, inf) if p.is_floating_point() else p,
        state["params"])
    return state


def run_line(name, r) -> str:
    return (f"  {name}: loss {r['losses'][0]:.4f} -> {r['losses'][-1]:.4f} "
            f"median step {r['step_ms']:.1f} ms, {r['tok_s']:.0f} tokens/s, "
            f"peak {r['peak_gb']:.2f} GB; launches={r['launches']} "
            f"plain_calls={r['plain']}\n    losses "
            f"{[round(x, 6) for x in r['losses']]}\n    grad norms "
            f"{[round(x, 6) for x in r['gnorms']]}")


def train_phase(torch, timer):
    """Training on the card (`repro_torch.runtime.train`): flash_mha's
    backward kernel against its plain version, then SmolLM-360M at
    published widths (batch 8, seq 256, 12 steps from the seed-0 init,
    remat by block): float32 through the kernels and through the plain
    versions (loss within 1e-3 relative at every step; from each state
    of the kernels' run, the loss within 1e-3 and the grad norm within
    1e-4 of the plain versions' step from that state; the loss falling),
    bf16 through the kernels (the main path, its steps timed alone), and
    a second such bf16 run checked from each of its states (the loss and
    grad norm within the gap between the plain versions' bf16 and
    float32 steps from that state); mamba2-780m (16 of 48 layers; batch 4, seq
    256, 6 steps) through ssd_scan against the plain versions in float32
    from the same states, and free-running within 1e-3 or ten times the
    gap of the plain versions' run from an init one float32 step away.
    Returns (launches of the path's kernels, flash_mha_bwd's record)."""
    from repro_torch import configs

    record = flash_bwd_cases(torch, timer)
    failures = []

    def gate(ok, what):
        if not ok:
            print(f"  FAIL {what}")
            failures.append(what)

    def same_state(r, what):
        """The kernels' loss and grad norm at each state of their own run
        against the plain versions' step from the same state (gates 1e-3
        and 1e-4 relative)."""
        gap = max(abs(x - y[0]) / abs(y[0]) for x, y in zip(r["losses"],
                                                           r["shadows"]))
        gn = [abs(x - y[1]) / y[1] for x, y in zip(r["gnorms"],
                                                    r["shadows"])]
        print(f"  {what}: kernels vs plain step from the same state over "
              f"{len(r['losses'])} steps: max relative loss gap {gap:.2e} "
              f"(gate 1e-3); grad norm gaps "
              f"{[float(f'{x:.2e}') for x in gn]} (gate 1e-4 each)")
        gate(gap <= 1e-3, f"{what} same-state loss gap {gap}")
        gate(max(gn) <= 1e-4, f"{what} same-state grad norm gap {max(gn)}")

    def same_state_bf16(r):
        """The kernels' bf16 loss and grad norm at each state of their own
        run against the plain versions' bf16 step from the same state,
        held to the gap between the plain versions' bf16 and float32
        steps from those states (the largest over the run): the kernels
        may part from the plain bf16 step by no more than bf16 compute
        parts from float32."""
        rel = lambda x, y: abs(x - y) / abs(y)  # noqa: E731
        sh, wi = r["shadows"], r["witnesses"]
        for i, what in ((0, "loss"), (1, "grad norm")):
            got = [rel(x, y[i]) for x, y in zip(
                r["losses"] if i == 0 else r["gnorms"], sh)]
            lim = [rel(y[i], w[i]) for y, w in zip(sh, wi)]
            print(f"  smollm bf16 {what}: kernels vs the plain bf16 step "
                  f"from the same state {[float(f'{x:.2e}') for x in got]};"
                  f" plain bf16 vs plain float32 step from it "
                  f"{[float(f'{x:.2e}') for x in lim]} (gate: kernels' max "
                  f"{max(got):.2e} <= the plain bf16 step's max "
                  f"{max(lim):.2e})")
            gate(all(math.isfinite(x) for x in got) and max(got) <= max(lim),
                 f"smollm bf16 same-state {what} gap {max(got)} above "
                 f"{max(lim)}")

    def gaps(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                     b["losses"])]

    def close_losses(a, b, what):
        finite = all(math.isfinite(x) for x in a["losses"] + b["losses"])
        gate(finite, f"{what}: non-finite losses")
        rel = max(gaps(a, b)) if finite else math.inf
        print(f"  {what}: max relative loss gap over {len(a['losses'])} "
              f"steps {rel:.2e} (gate 1e-3)")
        gate(rel <= 1e-3, f"{what} loss gap {rel}")

    cfg = configs.get("smollm_360m")
    assert cfg.dtype == "bfloat16"
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    print(f"train {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"H={cfg.num_heads}/{cfg.num_kv_heads} hd={cfg.head_dim} "
          f"ff={cfg.d_ff} vocab={cfg.vocab_size}; batch 8 x seq 256, 12 "
          "steps, lr 1e-3 (warmup 2), remat=block, seed-0 init; "
          + smi_line())
    k32 = train_run(torch, cfg32, None, 12, 8, 256, shadow=True)
    print(run_line("float32 kernels", k32))
    r32 = train_run(torch, cfg32, "reference", 12, 8, 256)
    print(run_line("float32 plain  ", r32))
    same_state(k32, "smollm float32")
    close_losses(k32, r32, "float32 kernels vs plain")
    gate(k32["losses"][-1] < k32["losses"][0], "the loss did not fall")
    gate(all(k32["launches"].get(k, 0) > 0 for k in
             ("flash_mha", "flash_mha_bwd")), f"launches {k32['launches']}")
    gate(not k32["plain"], f"plain calls in the kernel run {k32['plain']}")
    gate(not r32["launches"] and r32["plain"].get("mha_bwd", 0) > 0,
         f"plain run {r32['launches']} {r32['plain']}")
    del k32["state"], r32["state"]
    # the main path: the published bf16 compute on float32 masters, its
    # steps timed alone
    k16 = train_run(torch, cfg, None, 12, 8, 256)
    print(run_line("bf16 kernels (main path)", k16))
    gate(all(k16["launches"].get(k, 0) > 0 for k in
             ("flash_mha", "flash_mha_bwd")) and not k16["plain"],
         f"bf16 launches {k16['launches']} plain {k16['plain']}")
    gate(all(math.isfinite(x) for x in k16["losses"]), "bf16 loss")
    # one more bf16 step (the 13th) under the profiler: where a step's
    # device time goes
    from repro_torch.common.config import TrainConfig
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.runtime import train as train_rt

    step_fn = train_rt.build_train_step(cfg, TrainConfig(
        learning_rate=1e-3, total_steps=12, warmup_steps=2))
    b13 = {k: v.to("cuda") for k, v in make_batch_for(cfg, 256, 8,
                                                      12).items()}
    profile_calls(torch, lambda: step_fn(k16["state"], b13),
                  "smollm-360m bf16 train step")
    del k16["state"]
    # the bf16 same-state check in a run of its own (the main path's
    # steps stay timed alone): from each state of a second bf16 run
    # through the kernels the plain versions also take a bf16 step and a
    # float32 step
    c16 = train_run(torch, cfg, None, 12, 8, 256, shadow=True,
                    witness=cfg32)
    print(run_line("bf16 kernels (same-state check run)", c16))
    same_state_bf16(c16)
    del c16["state"]

    # resume bit-equal to a straight run: the launch phase runs the train
    # launcher itself (`train_launcher_resume`)

    # mamba2-780m through ssd_scan (float32 gate)
    mcfg = dataclasses.replace(cut_depth(configs.get("mamba2_780m")),
                               dtype="float32")
    print(f"train {mcfg.name}: {mcfg.num_layers}L d={mcfg.d_model} "
          f"heads={mcfg.ssm_heads}x{mcfg.ssm_head_dim} "
          f"state={mcfg.ssm_state}; batch 4 x seq 256, 6 steps, float32; "
          + smi_line())
    km = train_run(torch, mcfg, None, 6, 4, 256, shadow=True)
    print(run_line("float32 kernels", km))
    rm = train_run(torch, mcfg, "reference", 6, 4, 256)
    print(run_line("float32 plain  ", rm))
    same_state(km, "mamba2 float32")
    gate(km["launches"].get("ssd_scan", 0) > 0 and not km["plain"],
         f"mamba2 launches {km['launches']} plain {km['plain']}")
    del km["state"], rm["state"]
    # The free-running runs part after a few steps: the random 48-layer
    # stack's first grad norm is 57 (clipped to 1), and Adam's normalized
    # step turns small grad differences into +-lr moves. The witness: the
    # plain versions from the init moved by one float32 step part from
    # the plain run as well. The kernels' run is held to 1e-3 or to ten
    # times the witness's gap, whichever is larger.
    wm = train_run(torch, mcfg, "reference", 6, 4, 256,
                   state=nudged_init(torch, mcfg))
    kg, wg = gaps(km, rm), gaps(wm, rm)
    limit = max(1e-3, 10 * max(wg))
    finite = all(math.isfinite(x) for x in km["losses"] + wm["losses"])
    print(f"  mamba2 float32 free-running, relative loss gap to the plain "
          f"run by step: kernels {[float(f'{x:.2e}') for x in kg]}, plain "
          f"from the init one float32 step away "
          f"{[float(f'{x:.2e}') for x in wg]}; grad norms: plain "
          f"{[round(x, 4) for x in rm['gnorms']]}, kernels "
          f"{[round(x, 4) for x in km['gnorms']]}, nudged plain "
          f"{[round(x, 4) for x in wm['gnorms']]} (gate: kernels' max gap "
          f"{max(kg):.2e} <= max(1e-3, 10 x the nudged run's max gap) = "
          f"{limit:.2e})")
    gate(finite and max(kg) <= limit,
         f"mamba2 free-running gap {max(kg)} above {limit}")
    del wm["state"]
    if failures:
        raise AssertionError(f"train phase: {failures}")
    return ({"flash_mha_bwd": k16["launches"]["flash_mha_bwd"],
             "flash_mha": k16["launches"]["flash_mha"],
             "ssd_scan": km["launches"]["ssd_scan"]}, record)


def launch_phase(torch):
    """The serve launcher (`repro_torch.launch.serve`) at SmolLM-360M's
    published widths (seeded random weights, no --reduced) on the card:
    scenario chat, 8 requests, 8 slots, the default int8 pool; then
    `--fleet 2 --roles --prefill-chunk 16` on the same trace (chat's
    prompt buckets are 16 and 32 tokens: the launcher's own check
    refuses a chunk of 32, which does not divide 16). Gates: every
    request finishes; the launcher's tokens equal, request by request
    and bit for bit, those of a `ServingEngine` / `FleetRouter` built
    directly with the same `EngineConfig`, seed and device; the engine
    run launches flash_mha, write_pages and paged_flash_decode, the
    roles fleet the int8 chunk kernel, the handoff and
    paged_flash_decode, and neither runs a plain version. Returns the
    launcher runs' launches, summed."""
    from repro_torch import kernels
    from repro_torch.launch import serve as launcher
    from repro_torch.serving import ServingEngine, fleet

    print(f"launch on {smi_line()}")
    failures = []

    def gate(ok, what):
        if not ok:
            print(f"  FAIL {what}")
            failures.append(what)

    base = ["--arch", "smollm-360m", "--scenario", "chat", "--requests",
            "8", "--slots", "8"]
    runs = (("engine", base, ("flash_mha", "write_pages",
                              "paged_flash_decode")),
            ("fleet roles", [*base, "--fleet", "2", "--roles",
                             "--prefill-chunk", "16"],
             ("paged_prefill_insert_flash_q8", "handoff",
              "paged_flash_decode")))
    total: dict = {}
    for label, argv, need in runs:
        run = launcher.setup(argv)
        torch.cuda.synchronize()
        kernels.reset_counters()
        t0 = time.perf_counter()
        stats = launcher.run(run)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        plain = {k: v for k, v in kernels.REFERENCE_CALLS.items() if v}
        got = {r.request_id: [int(t) for t in r.output] for r in run.reqs}
        same = launcher.setup(argv)
        if same.fcfg is None:
            direct = ServingEngine.build(same.cfg, same.ecfg,
                                         seed=same.args.seed, device="cuda")
        else:
            direct = fleet.FleetRouter.build(same.cfg, same.ecfg, same.fcfg,
                                             seed=same.args.seed,
                                             device="cuda")
        direct.run(same.reqs)
        want = {r.request_id: [int(t) for t in r.output] for r in same.reqs}
        s = stats.summary()
        n_tok = s.get("tokens", 0)
        print(f"  {label}: `python -m repro_torch.launch.serve "
              f"{' '.join(argv)}`: {len(got)} requests, {n_tok} tokens in "
              f"{wall:.2f} s ({n_tok / wall:.1f} tok/s wall, launcher "
              f"process warm); pool {run.ecfg.pool_dtype}, page "
              f"{run.ecfg.page_tokens}, launches={launches} "
              f"plain_calls={plain}; tokens equal to the directly built "
              f"{'fleet' if same.fcfg else 'engine'}: {got == want}")
        gate(all(got.values()) and len(got) == 8, f"{label}: unfinished")
        gate(got == want, f"{label}: tokens differ from the direct build")
        gate(all(launches.get(k, 0) > 0 for k in need) and not plain,
             f"{label}: launches {launches} plain {plain}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        del direct
        torch.cuda.empty_cache()
    train_launcher_resume(torch, gate)
    if failures:
        raise AssertionError(f"launch phase: {failures}")
    return total


# `launch.train.main` in a process of its own, as a user runs the
# launcher, with `configs.get` cutting the arch to 2 layers (widths kept)
LAUNCH_TRAIN_2L = (
    "import dataclasses, sys\n"
    "from repro_torch import configs\n"
    "get = configs.get\n"
    "configs.get = lambda name: dataclasses.replace(get(name), "
    "num_layers=2)\n"
    "from repro_torch.launch import train\n"
    "train.main(sys.argv[1:])\n")


def train_launcher_resume(torch, gate) -> None:
    """The train launcher's `main` (its own process, as a user runs it)
    on SmolLM-360M at published widths cut to 2 layers
    (`LAUNCH_TRAIN_2L`), batch 8 x 256, bf16: 4 steps straight
    (checkpoints at 2 and 4), then the step-2 checkpoint alone in a fresh
    directory and `--resume` to step 4. Gate: the two step-4
    checkpoints' leaves bit-equal (their manifests' sha1), which needs
    the launcher's deterministic algorithms (the embedding's backward
    accumulates with atomics otherwise)."""
    import os
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="launch_train_")
    argv = [sys.executable, "-c", LAUNCH_TRAIN_2L, "--arch", "smollm_360m",
            "--batch", "8", "--seq", "256", "--steps", "4", "--ckpt-every",
            "2", "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    try:
        t0 = time.perf_counter()
        runs = {}
        for name in ("straight", "resumed"):
            extra = ["--ckpt-dir", f"{tmp}/{name}"]
            if name == "resumed":
                shutil.copytree(f"{tmp}/straight/step_00000002",
                                f"{tmp}/resumed/step_00000002")
                extra.append("--resume")
            out = subprocess.run(argv + extra, env=env, capture_output=True,
                                 text=True, timeout=600)
            if out.returncode:
                raise AssertionError(f"launch.train {name}: "
                                     f"{out.stderr[-3000:]}")
            with open(f"{tmp}/{name}/step_00000004/manifest.json") as f:
                runs[name] = {e["name"]: e["sha1"]
                              for e in json.load(f)["leaves"]}
            lines = [ln for ln in out.stdout.splitlines()
                     if ln.startswith(("step", "resumed"))]
            print(f"  launch.train {name}: {'; '.join(lines)}")
        diff = [n for n in runs["straight"]
                if runs["straight"][n] != runs["resumed"].get(n)]
        print(f"  launch.train, 2 layers: 4 straight steps vs 2 + --resume "
              f"2: {len(runs['straight']) - len(diff)} of "
              f"{len(runs['straight'])} leaves bit-equal at step 4 "
              f"({time.perf_counter() - t0:.1f} s, two processes)")
        gate(runs["straight"] and not diff,
             f"launch.train resume differs in {diff[:4]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def tiering_phase(torch, timer):
    """The tiered train step (`runtime.tiering.apply_tier_shardings`) at
    SmolLM-360M's published widths: batch 8 x 256, the hotness policy at
    pool_fraction 0.5, 3 steps from the seed-0 init, beside the untiered
    step from the same init and batches. The pool-tier leaves live in
    pinned host memory and come in and go out through the page copy
    (`state_in` / `state_out`). Both runs take their steps under
    `torch.use_deterministic_algorithms(True)` (the embedding's backward
    uses atomics otherwise). Gates: the probes say "inputs+outputs"
    and the substrate "physical"; at every step the tiered run's loss,
    grad norm and every state leaf bit-equal to the untiered run's; the
    page copy's launches per step equal to the step's plan (one in and
    one out per launch group) and above 0; no plain version; the host
    leaves still pinned, the same tensors. Prints the pool bytes, each
    run's step ms and the in / out copy ms of the kernel, of the plain
    copy_pages and of `copy_(non_blocking=True)` a leaf (CUDA events
    around a call).
    Returns the tiered step's launches per step."""
    from repro_torch import configs, kernels
    from repro_torch.common.config import ShapeConfig, TrainConfig
    from repro_torch.common.pytree import named_leaves
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.runtime import tiering
    from repro_torch.runtime import train as train_rt

    failures = []

    def gate(ok, what):
        if not ok:
            print(f"  FAIL {what}")
            failures.append(what)

    cfg = configs.get("smollm_360m")
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=12, warmup_steps=2)
    shape = ShapeConfig("train_256", 256, 8, "train")
    bundle = train_rt.make_bundle(cfg, tcfg)
    _, tb, info = tiering.apply_tier_shardings(
        cfg, tcfg, bundle, shape, policy="hotness", pool_fraction=0.5)
    step = tb.step_fn
    print(f"tiering {cfg.name}: batch 8 x 256, policy hotness, "
          f"pool_fraction 0.5, 3 steps; {len(step.host_names)} of "
          f"{len(named_leaves(bundle.abstract_state))} leaves in pinned "
          f"host memory ({info['pool_leaf_bytes'] / 1e9:.3f} GB; placement"
          f" {info['pool_bytes_per_dev'] / 1e9:.3f} GB pool, "
          f"{info['local_bytes_per_dev'] / 1e9:.3f} GB local), "
          f"{len(step.plan)} copy launch(es) each way a step; "
          f"host_annotation {info['host_annotation']}, substrate "
          f"{info['substrate_mode']}; {smi_line()}")
    gate(info["host_annotation"] == "inputs+outputs"
         and info["substrate_mode"] == "physical", f"probes {info}")
    batches = [{k: v.to("cuda") for k, v in make_batch_for(
        cfg, 256, 8, s).items()} for s in range(3)]
    plain = train_rt.init_train_state(
        cfg, torch.Generator("cuda").manual_seed(0))
    tiered = tiering.place_state(train_rt.init_train_state(
        cfg, torch.Generator("cuda").manual_seed(0)), step.host_names,
        pin=True)
    held = {n: x for n, x in named_leaves(tiered) if n in step.host_names}
    gate(all(x.is_pinned() for x in held.values()), "host leaves pinned")
    per_step, ms_plain, ms_tier = {}, [], []
    # the embedding's and the label gather's backward accumulate with
    # atomics unless deterministic algorithms are on: two untiered steps
    # from one state would differ in their last bits too
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain, pm = bundle.step_fn(plain, b)
        loss_p = float(pm["loss"])
        ms_plain.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        kernels.reset_counters()
        t0 = time.perf_counter()
        tiered, tm = step(tiered, b)
        loss_t = float(tm["loss"])
        torch.cuda.synchronize()
        ms_tier.append((time.perf_counter() - t0) * 1e3)
        per_step = {k: v for k, v in kernels.LAUNCHES.items() if v}
        plain_calls = {k: v for k, v in kernels.REFERENCE_CALLS.items() if v}
        diff = [n for (n, x), (_, y) in zip(named_leaves(plain),
                                            named_leaves(tiered))
                if not torch.equal(x, y.to(x.device))]
        print(f"  step {i}: loss {loss_p:.6f} / {loss_t:.6f}, grad norm "
              f"{float(pm['grad_norm']):.6f} / {float(tm['grad_norm']):.6f}"
              f" (untiered / tiered); {len(diff)} leaves differ; "
              f"launches {per_step}")
        gate(torch.equal(pm["loss"], tm["loss"])
             and torch.equal(pm["grad_norm"], tm["grad_norm"]) and not diff,
             f"step {i}: tiered differs ({diff[:4]})")
        n = len(step.plan)
        gate(n > 0 and per_step.get("state_in") == n
             and per_step.get("state_out") == n,
             f"step {i}: page copies {per_step} against the plan's {n}")
        gate(not plain_calls, f"step {i}: plain calls {plain_calls}")
        gate(all(x is held[n_] and x.is_pinned() for n_, x in
                 named_leaves(tiered) if n_ in held),
             f"step {i}: host leaves moved")
    torch.use_deterministic_algorithms(prev)
    dev = torch.device("cuda")
    bufs = step.bring_in(tiered, dev)
    in_ms = timer.event_ms(lambda: step.bring_in(tiered, dev))
    out_ms = timer.event_ms(lambda: step.write_back(bufs, held))
    nbytes = info["pool_leaf_bytes"]
    print(f"  step ms (wall, synchronized, deterministic algorithms on):"
          f" untiered "
          f"{[round(x, 1) for x in ms_plain]}, tiered "
          f"{[round(x, 1) for x in ms_tier]}; copies of the "
          f"{nbytes / 1e9:.3f} GB pool leaves: in {in_ms:.3f} ms "
          f"({nbytes / in_ms / 1e6:.1f} GB/s), out {out_ms:.3f} ms "
          f"({nbytes / out_ms / 1e6:.1f} GB/s); {smi_line()}")

    # the same leaves both ways through the plain copy_pages (3 calls
    # each: its host side is slow) and through one library call a leaf,
    # `copy_(non_blocking=True)` on the copy engine, into the same
    # buffers and pinned leaves (the values written are the ones there)
    from repro_torch.kernels.page_io import ops as pops

    def plain(name, dst, src):
        for group in step.plan:
            pops.copy_pages([tiering._pages(dst[n]) for n in group], None,
                            [tiering._pages(src[n]) for n in group], None,
                            name=name, impl="reference")

    def library(dst, src):
        for n in step.host_names:
            dst[n].copy_(src[n], non_blocking=True)

    slow = Timer(torch, reps=3)
    plain_in = slow.event_ms(lambda: plain("state_in", bufs, held))
    plain_out = slow.event_ms(lambda: plain("state_out", held, bufs))
    lib_in = timer.event_ms(lambda: library(bufs, held))
    lib_out = timer.event_ms(lambda: library(held, bufs))
    print(f"  the same leaves: plain copy_pages in {plain_in:.3f} ms, out "
          f"{plain_out:.3f} ms; copy_(non_blocking=True) a leaf in "
          f"{lib_in:.3f} ms ({nbytes / lib_in / 1e6:.1f} GB/s), out "
          f"{lib_out:.3f} ms ({nbytes / lib_out / 1e6:.1f} GB/s); events "
          f"around a call; {smi_line()}")
    del slow
    del bufs, plain, tiered, held
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"tiering phase: {failures}")
    return per_step


# the dry-run cells traced over the reference's 16x16 mesh (rank 0 of
# 256 H100s; ROADMAP A16c) beside the one-card `--all`
MESH_DRYRUN = (("qwen2.5-32b", "decode_32k"), ("qwen2.5-32b", "train_4k"),
               ("mamba2-780m", "decode_32k"),
               ("seamless-m4t-large-v2", "decode_32k"))


def start_dryrun() -> dict:
    """Start `python -m repro_torch.launch.dryrun --all` (every cell of
    `configs.all_cells()` on meta tensors, in spawned processes, at most
    one per core; the card is idle) and, for each of MESH_DRYRUN, `--mesh
    16x16 --arch A --shape S`, in subprocesses of their own sessions at
    nice 10, writing into a temporary directory: they take the cores the
    kernels' build leaves idle, and `finish_dryrun` waits for them before
    the card is timed. An exit handler stops their process groups if the
    script ends first."""
    import atexit
    import os
    import signal
    import tempfile

    out = tempfile.mkdtemp(prefix="dryrun_torch_")
    jobs = len(os.sched_getaffinity(0))
    log = open(Path(out) / "dryrun.log", "w")
    cmds = [["--all"]] + [["--mesh", "16x16", "--arch", a, "--shape", s]
                          for a, s in MESH_DRYRUN]
    procs = [subprocess.Popen(
        ["nice", "-n", "10", sys.executable, "-m", "repro_torch.launch.dryrun",
         *cmd, "--outdir", out],
        stdout=log, stderr=subprocess.STDOUT, start_new_session=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"))) for cmd in cmds]

    def stop():
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()

    atexit.register(stop)
    return dict(procs=procs, out=out, log=log, jobs=jobs, stop=stop,
                t0=time.perf_counter())


def finish_dryrun(run: dict) -> list:
    """Wait for `start_dryrun`'s run and return its records; raises if it
    failed (its log's end printed)."""
    import shutil

    t_wait = time.perf_counter()
    rcs = [p.wait() for p in run["procs"]]
    rc = max(rcs)
    run["log"].close()
    out = Path(run["out"])
    log = (out / "dryrun.log").read_text()
    secs = time.perf_counter() - run["t0"]
    print(f"dryrun: `python -m repro_torch.launch.dryrun --all` ("
          f"{run['jobs']} cores) and `--mesh 16x16` on {MESH_DRYRUN} "
          f"started with the build at nice 10: rcs {rcs}, "
          f"{secs:.1f} s, {time.perf_counter() - t_wait:.1f} s of it "
          "waited for after the build (meta tensors, the card idle)")
    if rc != 0:
        print(log[-4000:])
        raise AssertionError(f"dry-run --all exited {rc}")
    records = [json.loads(p.read_text()) for p in sorted(out.glob("*.json"))]
    shutil.rmtree(out, ignore_errors=True)
    return records


def dryrun_phase(torch, tier_launches, results):
    """The records of `start_dryrun`'s run (`results`): every cell of
    `configs.all_cells()` `ok`, each cell's dominant term and
    t_compute_s printed; the MESH_DRYRUN cells over 16x16 `ok`, priced
    on 256 cards with wire bytes, their collectives printed. Gate: the
    dry-run of SmolLM-360M's tiered train
    step at the tiering phase's shape (batch 8 x 256, one microbatch,
    remat by block) counts as many flash_mha, flash_mha_bwd, state_in
    and state_out units as the card's step launched
    (`tier_launches`)."""
    from repro_torch import configs
    from repro_torch.common.config import ShapeConfig
    from repro_torch.launch import dryrun

    meshed = [r for r in results if r["mesh"] != dryrun.MESH]
    results = [r for r in results if r["mesh"] == dryrun.MESH]
    cells = {(r["arch"], r["shape"]) for r in results}
    print(f"dryrun: {len(results)} records for the "
          f"{len(configs.all_cells())} cells of configs.all_cells()")
    for r in meshed:
        hc, rl = r["hlo_cost"], r["roofline"]
        mb = f" mb {r['microbatches']}" if "microbatches" in r else ""
        wire = {k: round(v) for k, v in hc["collectives"].items()}
        print(f"  {r['arch']} x {r['shape']} @ {r['mesh']} "
              f"({r.get('n_devices')} H100s, rank 0){mb}: "
              f"{rl['dominant']}-bound, t_compute_s "
              f"{rl['t_compute_s']:.6g}, t_memory_s {rl['t_memory_s']:.6g}, "
              f"t_collective_s {rl['t_collective_s']:.6g}; wire "
              f"{hc['wire_bytes_per_device'] / 1e9:.4f} GB a rank, "
              f"collectives {hc['collective_counts']} bytes {wire}, temp "
              f"{r['memory_analysis']['temp_bytes'] / 1e9:.2f} GB, units "
              f"{r['dispatch_cost']['units']} ({r['wall_s']} s)")
    want = {(configs.canonical(a), s) for a, s in MESH_DRYRUN}
    if {(r["arch"], r["shape"]) for r in meshed} != want or not all(
            r["status"] == "ok" and r["n_devices"] == 256
            and r["hlo_cost"]["wire_bytes_per_device"] > 0 for r in meshed):
        raise AssertionError(f"dryrun phase: the 16x16 cells {meshed}")
    for r in results:
        rl, ma = r["roofline"], r["memory_analysis"]
        print(f"  {r['arch']} x {r['shape']}"
              f"{' mb ' + str(r['microbatches']) if 'microbatches' in r else ''}"
              f": {rl['dominant']}-bound, t_compute_s {rl['t_compute_s']:.6g},"
              f" t_memory_s {rl['t_memory_s']:.6g}, temp "
              f"{ma['temp_bytes'] / 1e9:.2f} GB, units "
              f"{r['dispatch_cost']['units']} ({r['wall_s']} s)")
    if cells != set(configs.all_cells()) or not all(
            r["status"] == "ok" for r in results):
        raise AssertionError("dryrun phase: a cell failed or is missing")
    cost, _, info, _ = dryrun.cell_cost(
        configs.get("smollm_360m"), ShapeConfig("train_256", 256, 8, "train"),
        microbatches=1, tier_policy="hotness", pool_fraction=0.5)
    keys = ("flash_mha", "flash_mha_bwd", "state_in", "state_out")
    units = {k: cost.units.get(k, 0) for k in keys}
    card = {k: tier_launches.get(k, 0) for k in keys}
    print(f"  smollm-360m tiered train step at 8 x 256: dry-run units "
          f"{units}, the card's launches a step {card}")
    if units != card or not all(card.values()):
        raise AssertionError(f"dryrun phase: units {units} != launches "
                             f"{card}")


# ------------------------------------------------------------------ mesh
MESH_ARCH = "granite_3_2b"
MESH_CELL = dict(n_slots=8, max_seq=256, prefill_buckets=(64, 128),
                 page_tokens=16)
# the dp2tp2 runs (both gated; the fp run's weights also give the prompt
# passes in float32 and bf16 that gate bf16 on the mesh); the meshless
# engine also serves the bf16 int8 main path, which the (1, 1) NCCL rank
# must match bit for bit
# the contiguous layout over the mesh (ROADMAP A16c): its float32 run
# gated token-equal to the meshless contiguous engine (and its weights
# give the serve bundle's decode-step logits in float32 and bf16); the
# (1, 1) rank's bf16 run bit-equal to the meshless engine's
CONTIG_F32 = dict(name="f32 contiguous", dtype="float32", pool_dtype="fp",
                  paged=False, decode_logits=True)
CONTIG_BF16 = dict(name="bf16 contiguous", dtype="bfloat16", pool_dtype="fp",
                   paged=False)
# caches of 255 positions (ROADMAP A16f): the extent does not divide over
# the model axis, so they stay whole on every rank, which decodes its own
# query heads with flash_decode and no lse or merge (each rank holds half
# of the caches' bytes, its slots over data); float32 tokens gated equal
# to the meshless engine's on the same cell
CONTIG_WHOLE = dict(name="f32 contiguous 255", dtype="float32",
                    pool_dtype="fp", paged=False, max_seq=255,
                    whole=("k", "v"))
MESH_RUNS = (dict(name="f32 fp", dtype="float32", pool_dtype="fp",
                  logits=True),
             dict(name="f32 int8", dtype="float32", pool_dtype="int8"),
             CONTIG_F32, CONTIG_WHOLE)
MAIN_RUN = dict(name="bf16 int8", dtype="bfloat16", pool_dtype="int8")
ONE_RUNS = (MAIN_RUN, CONTIG_BF16)
CONTIG_KERNELS = ("flash_mha", "flash_decode_lse")
CONTIG_WHOLE_KERNELS = ("flash_mha", "flash_decode")
# moe_ep at granite-moe's widths with capacity 8.0 (no pair drops, as
# moe_dense) and with the config's capacity (the dispatch drops pairs past
# it); its gradients also at an odd sequence (S 127 on an EP axis of 2:
# every rank routes every token)
MOE_CAPS = (("no drops", 8.0), ("config", None))
MOE_ODD_SHAPE = (2, 127)
# granite-3-2b's serving runs on the mesh are cut to 8 of its 40 layers
# (widths kept): their gates (float32 equality and agreement, bf16
# relative drift, bit-equality) hold at any depth, and the cut pays for
# the stacks below and their training
MESH_SERVE_LAYERS = 8

# the other stacks over the mesh (ROADMAP A16d), after granite's runs on
# the same ranks: mamba2-780m (d 1536, 48 SSM heads of 64, state 128) cut
# to 4 of its 48 layers and seamless-m4t-large-v2 (d 1024, 16 / 16 heads,
# ff 8192, vocab 256206) cut to 4 + 4 layers, widths kept, 4 chat
# requests of 16 new tokens on 4 slots. dp2tp2: float32 paged fp (its
# weights give the prompt passes of the bf16 gate) and float32
# contiguous, gated token-equal to the meshless engine; (1, 1): the bf16
# int8 main path bit-equal
MESH_STACKS = {"mamba2_780m": dict(num_layers=4),
               "seamless_m4t_large_v2": dict(num_layers=4,
                                             num_encoder_layers=4)}
MESH_STACK_BUCKETS = {"mamba2_780m": (64, 128),
                      "seamless_m4t_large_v2": (128,)}
MESH_STACK_CELL = dict(n_slots=4, max_seq=256, page_tokens=16)
MESH_STACK_RUNS = (dict(name="f32 fp", dtype="float32", pool_dtype="fp",
                        logits=True),
                   dict(name="f32 contiguous", dtype="float32",
                        pool_dtype="fp", paged=False))
MESH_STACK_MAIN = dict(name="bf16 int8", dtype="bfloat16", pool_dtype="int8")
# the kernels every rank must launch, by arch and layout (paged or not):
# the contiguous cross-attention decodes its block of encoder positions
# with the lse and merges over tp
MESH_STACK_KERNELS = {
    "mamba2_780m": {True: ("ssd_scan",), False: ("ssd_scan",)},
    "seamless_m4t_large_v2": {
        True: ("flash_mha", "write_pages", "paged_flash_decode",
               "flash_decode"),
        False: ("flash_mha", "flash_decode_lse")}}
# ngram speculation (k 4) on granite over the mesh, against the greedy
# mesh engine on the same 4 requests of 16 new tokens
MESH_SPEC_RUNS = (dict(name="f32 greedy", dtype="float32", pool_dtype="fp"),
                  dict(name="f32 ngram", dtype="float32", pool_dtype="fp",
                       speculative="ngram", speculative_k=4))


# training on the mesh: granite-3-2b at published widths cut to 8 of its
# 40 layers (the four dp2tp2 ranks, the (1, 1) rank, the meshless twin
# and the serving engines share one card, and gloo moves every FSDP
# gather through host memory), batch 8 x 256, remat by block. At 4
# layers the compressed_psum gate read 1.0000029 of its bound (ROADMAP
# §C): the depth stays where that gate has held
MESH_TRAIN_LAYERS = 8
MESH_TRAIN_SHAPE = (8, 256)             # batch, seq
MESH_TRAIN_TCFG = dict(total_steps=10, warmup_steps=2, remat="block")
MESH_TRAIN_KERNELS = ("flash_mha", "flash_mha_bwd")


def mesh_train_inputs(cfg, params, device="cuda") -> dict:
    """The mesh train runs' inputs: `cfg` cut to MESH_TRAIN_LAYERS, its
    float32 masters (the first layers of `params`: views, which the ranks
    take by CUDA IPC) and two synthetic batches."""
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.optim.adamw import tree_map

    n = MESH_TRAIN_LAYERS
    tcfg = dataclasses.replace(cfg, num_layers=n)
    B, S = MESH_TRAIN_SHAPE
    return dict(cfg=tcfg, device=device,
                params=dict(params, blocks=tree_map(lambda x: x[:n],
                                                    params["blocks"])),
                batches=[make_batch_for(tcfg, S, B, s) for s in range(2)])


def mesh_train_reference(torch, inp) -> None:
    """The meshless bundle's two steps on `inp`'s masters and batches in
    this process, in float32 and in bf16, into inp["ref"]: losses, grad
    norms, the lrs summed, wall ms a step, the per-token NLL before each
    step (`dev_train_torch.token_nll`; in bf16 also before the first
    step with the row-parallel products split as dp2tp2 splits them,
    `dev_train_torch.tp_split_products`), and the float32 final state,
    for the ranks to hold their shards against."""
    import dev_train_torch as dtt
    from repro_torch.common.config import TrainConfig
    from repro_torch.runtime import train as train_rt

    device, ref = inp["device"], {}

    def bundle_cfg(dt):
        return dataclasses.replace(inp["cfg"], dtype=dt)

    for dt in ("float32", "bfloat16"):
        bundle = train_rt.make_bundle(
            dataclasses.replace(inp["cfg"], dtype=dt),
            TrainConfig(**MESH_TRAIN_TCFG))
        state = dtt.global_state(inp["params"], device)
        batches = inp["batches"]
        r = dict(losses=[], gnorms=[], ms=[], lr_sum=0.0, token_nll=[])
        if dt == "bfloat16":
            with dtt.tp_split_products(2):
                r["tp2_token_nll"] = dtt.token_nll(
                    state["params"], batches[0], bundle_cfg(dt)
                ).cpu().numpy()
        for b in batches:
            r["token_nll"].append(dtt.token_nll(
                state["params"], b, bundle_cfg(dt)).cpu().numpy())
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = bundle.step_fn(state, b)
            r["losses"].append(float(m["loss"]))      # synchronizes
            r["ms"].append((time.perf_counter() - t0) * 1e3)
            r["gnorms"].append(float(m["grad_norm"]))
            r["lr_sum"] += float(m["lr"])
        if dt == "float32":
            r["state"] = state
        ref[dt] = r
        del state, bundle
    inp["ref"] = ref
    if device == "cuda":
        torch.cuda.empty_cache()   # the ranks share the card


def mesh_train_one(inp) -> tuple:
    """The (1, 1) rank's train call: two bf16 steps under deterministic
    algorithms beside the meshless bundle's steps in the rank's
    process."""
    import dev_train_torch as dtt

    return (dtt.mesh_train_rank, (
        inp["cfg"], 1, 1, inp["params"], inp["batches"],
        [dict(name="bf16 (1, 1)", dtype="bfloat16", tcfg=MESH_TRAIN_TCFG,
              deterministic=True, against_meshless=True)], inp["device"]))


def mesh_train_four(inp) -> tuple:
    """The dp2tp2 ranks' train call, every step under deterministic
    algorithms (a replica's grads must not depend on atomics' order):
    two float32 steps, their final shards against the meshless float32
    state of `mesh_train_reference`; two bf16 steps with the per-token
    NLL before each, `compressed_psum` over the first step's grads over
    `data` and over both axes, and the tiered step beside the first."""
    import dev_train_torch as dtt

    tc = MESH_TRAIN_TCFG
    f32 = inp["ref"]["float32"]
    return (dtt.mesh_train_rank, (
        inp["cfg"], 2, 2, inp["params"], inp["batches"],
        [dict(name="f32", dtype="float32", tcfg=tc, deterministic=True,
              compare=dict(state=f32["state"], lr_sum=f32["lr_sum"])),
         dict(name="bf16", dtype="bfloat16", tcfg=tc, deterministic=True,
              token_nll=True, compress=[("data",), ("data", "model")],
              tier=dict(policy="hotness", pool_fraction=0.5),
              tier_steps=1)], inp["device"]))


def mesh_train_gates(inp, one, four, gate) -> dict:
    """Prints and gates the mesh train runs (`one`: the (1, 1) rank's run;
    `four`: each dp2tp2 rank's [f32, bf16] runs). Returns rank 0's f32
    launches."""
    import numpy as np

    import dev_train_torch as dtt

    ref32, ref16 = inp["ref"]["float32"], inp["ref"]["bfloat16"]
    cfg = inp["cfg"]
    print(f"  mesh train {cfg.name}: {cfg.num_layers} of 40 layers, d "
          f"{cfg.d_model}, {cfg.num_heads} / {cfg.num_kv_heads} heads, ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}; batch "
          f"{MESH_TRAIN_SHAPE[0]} x {MESH_TRAIN_SHAPE[1]}, remat block, "
          f"seed-0 float32 masters; meshless float32 losses "
          f"{ref32['losses']} grad norms {ref32['gnorms']} "
          f"({[round(x, 1) for x in ref32['ms']]} ms a step), bf16 losses "
          f"{ref16['losses']} ({[round(x, 1) for x in ref16['ms']]} ms)")
    # --- (1, 1) on NCCL -------------------------------------------------
    m = one["meshless"]
    print(f"  mesh train (1, 1) nccl bf16, deterministic: losses "
          f"{one['losses']} grad norms {one['grad_norms']} vs the meshless "
          f"bundle's {m['steps']} in the rank's process: equal "
          f"{m['steps_equal']}; state leaves bit-equal {m['leaves_equal']} "
          f"of {m['leaves']}; {[round(x, 1) for x in one['step_ms']]} ms a "
          f"step wall; launches {one['launches']} plain {one['plain']}")
    gate(m["steps_equal"] and m["leaves_equal"] == m["leaves"],
         "mesh train (1, 1): not bit-equal to the meshless bundle")
    gate(all(one["launches"].get(k, 0) > 0 for k in MESH_TRAIN_KERNELS)
         and not one["plain"], f"mesh train (1, 1): launches "
         f"{one['launches']} plain {one['plain']}")
    # --- dp2tp2, float32 ------------------------------------------------
    f32, bf16 = [r[0] for r in four], [r[1] for r in four]
    for name, runs in (("f32", f32), ("bf16", bf16)):
        bad = dtt.replicas_equal([r["digests"] for r in runs])
        sizes = {(r["state_bytes"], r["share_bytes"]) for r in runs}
        print(f"  mesh train dp2tp2 {name}: replicas bit-equal "
              f"{not bad} {bad[:4]}; state bytes a rank / spec share "
              f"{sorted(sizes)}")
        gate(not bad, f"mesh train dp2tp2 {name}: replicas differ {bad[:4]}")
        gate(all(a == b for a, b in sizes),
             f"mesh train dp2tp2 {name}: state bytes {sorted(sizes)}")
        for r in runs:
            gate(all(r["launches"].get(k, 0) > 0 for k in MESH_TRAIN_KERNELS)
                 and not r["plain"], f"mesh train dp2tp2 {name} rank "
                 f"{r['coord']}: launches {r['launches']} plain {r['plain']}")
    for r in f32:
        d_loss = max(abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                          ref32["losses"]))
        d_norm = max(abs(a - b) / abs(b) for a, b in zip(r["grad_norms"],
                                                          ref32["gnorms"]))
        c = r["compare"]
        peak = ("not measured" if r["peak_gb"] is None
                else f"{r['peak_gb']:.2f} GB")
        print(f"    rank {r['coord']} f32: loss rel err {d_loss:.2e}, grad "
              f"norm {d_norm:.2e}; state vs meshless: updates within 1e-2 "
              f"lr on {c['update_share']:.5f} of the worst leaf, worst "
              f"{c['update_err_over_lr']:.3e} lr, moments "
              f"{c['moment_err']:.2e} of their max; "
              f"{[round(x, 1) for x in r['step_ms']]} ms a step wall; "
              f"peak {peak}; launches {r['launches']}")
        gate(d_loss <= 1e-5 and d_norm <= 1e-5,
             f"mesh train dp2tp2 f32 rank {r['coord']}: loss {d_loss}, "
             f"grad norm {d_norm}")
        gate(c["update_share"] >= 0.999 and c["update_err_over_lr"] <= 2.2
             and c["moment_err"] <= 1e-4 and c["counts_equal"],
             f"mesh train dp2tp2 f32 rank {r['coord']}: state {c}")
    # --- dp2tp2, bf16 -----------------------------------------------------
    for r in bf16:
        t = r["tier"]
        print(f"    rank {r['coord']} bf16: tiered step bit-equal "
              f"{t['equal']} ({t['n_host']} leaves, "
              f"{t['pool_bytes'] / 1e6:.1f} MB pinned a rank); "
              f"{[round(x, 1) for x in r['step_ms']]} ms a step wall; "
              f"launches {r['launches']}")
        gate(t["equal"] == [True], f"tiered step rank {r['coord']}: "
             f"{t['equal']}")
        for cp in r["compress"]:
            print(f"      compressed_psum over {cp['axes']}: error state "
                  f"bit-equal to the plain recomputation "
                  f"{cp['error_state_equal']}; mean error "
                  f"{cp['mean_over_bound']:.3f} of its quantization bound;"
                  f" wire {cp['wire_bytes_int32'] / 1e6:.1f} MB as int32 vs "
                  f"{cp['wire_bytes_float32'] / 1e6:.1f} MB float32 (int8 "
                  f"would be a quarter)")
            gate(cp["error_state_equal"] and cp["mean_over_bound"] <= 1.0,
                 f"compressed_psum {cp['axes']} rank {r['coord']}: {cp}")
    # bf16 on the mesh: before the first step (one state, forward only)
    # the mesh's per-token NLL no further (RMS over the global batch's
    # tokens) from the meshless bf16 forward with the row-parallel products
    # split as the mesh splits them (`tp_split_products`: a bf16 sum of two
    # bf16 halves, as XLA's partitioner gives the reference) than meshless
    # bf16 is from float32. Printed: the distances to the unsplit meshless
    # bf16 forward and the mean-loss drifts over both steps. Those compare
    # the split's rounding with bf16's own, which are of one size on this
    # model (PERF.md §6, the mesh train findings), so they gate nothing
    rms = lambda a, b: float(np.sqrt(np.mean((a - b) ** 2)))  # noqa: E731
    m0, b0, f0 = bf16[0]["token_nll"][0], ref16["token_nll"][0], \
        ref32["token_nll"][0]
    d_split = rms(m0, ref16["tp2_token_nll"])
    d_own = rms(b0, f0)
    d_plain = [rms(m, b) for m, b in zip(bf16[0]["token_nll"],
                                         ref16["token_nll"])]
    d_dtypes = [rms(b, f) for b, f in zip(ref16["token_nll"],
                                          ref32["token_nll"])]
    d_mesh = max(abs(a - b) for r in bf16
                 for a, b in zip(r["losses"], ref16["losses"]))
    d_dtype = max(abs(a - b) for a, b in zip(ref16["losses"],
                                             ref32["losses"]))
    ms = [x for r in bf16 for x in r["step_ms"]]
    print(f"  mesh train dp2tp2 bf16: losses {bf16[0]['losses']}; per-token "
          f"NLL RMS before the first step: mesh vs the split meshless bf16 "
          f"{d_split:.3e}, meshless bf16 vs float32 {d_own:.3e} (gate: the "
          f"first <= the second); printed: mesh vs meshless bf16 "
          f"{[f'{x:.3e}' for x in d_plain]}, meshless bf16 vs float32 "
          f"{[f'{x:.3e}' for x in d_dtypes]} before each step, split vs "
          f"unsplit meshless bf16 {rms(ref16['tp2_token_nll'], b0):.3e}; "
          f"mean loss |mesh - meshless bf16| {d_mesh:.3e}, |meshless bf16 "
          f"- float32| {d_dtype:.3e}; wall ms a step "
          f"{min(ms):.1f}-{max(ms):.1f} over the ranks (gloo through host "
          f"memory, 4 ranks on one card) vs meshless "
          f"{[round(x, 1) for x in ref16['ms']]}")
    gate(all(np.array_equal(r["token_nll"][0], m0) for r in bf16),
         "mesh train bf16: the ranks' token NLLs differ")
    gate(d_split <= d_own, f"mesh train bf16: per-token drift from the "
         f"split meshless forward {d_split} > bf16's own {d_own}")
    return f32[0]["launches"]


# the other stacks' training on the same ranks (ROADMAP A16e), after
# granite's: published widths, depth cut, seeded float32 masters (the
# serving stacks' first layers where they exist) by CUDA IPC, one step of
# batch 4 x 128 tokens (paligemma adds its 256 patch embeddings, seamless
# its 128 frames), remat by block. dp2tp2: float32 gated against the
# meshless float32 step taken here, bf16 printed; (1, 1) on NCCL: mamba2
# in bf16 bit-equal to the meshless bundle in the rank's process
MESH_TRAIN_STACKS = {"mamba2_780m": dict(num_layers=2),
                     "paligemma_3b": dict(num_layers=2),
                     "seamless_m4t_large_v2": dict(num_layers=2,
                                                   num_encoder_layers=2)}
MESH_TRAIN_STACK_SHAPE = (4, 128)           # batch, seq
MESH_TRAIN_STACK_KERNELS = {
    "mamba2_780m": ("ssd_scan",),
    "paligemma_3b": ("flash_mha", "flash_mha_bwd"),
    "seamless_m4t_large_v2": ("flash_mha", "flash_mha_bwd")}
MESH_TRAIN_STACK_ONE = "mamba2_780m"


def mesh_train_stack_inputs(torch, arch, serve_params=None,
                            device="cuda") -> dict:
    """One stack's mesh train inputs: its published config cut by
    MESH_TRAIN_STACKS, float32 masters (the first layers of
    `serve_params`, views, or drawn from seed 0 on `device`) and one
    synthetic batch of MESH_TRAIN_STACK_SHAPE."""
    from repro_torch import configs
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import tree_map

    cfg = dataclasses.replace(configs.get(arch), **MESH_TRAIN_STACKS[arch])
    if serve_params is None:
        params = M.init_model(cfg, torch.Generator(device).manual_seed(0))
    else:
        params = dict(serve_params, blocks=tree_map(
            lambda x: x[:cfg.num_layers], serve_params["blocks"]))
        if cfg.num_encoder_layers:
            enc = serve_params["encoder"]
            params["encoder"] = dict(enc, blocks=tree_map(
                lambda x: x[:cfg.num_encoder_layers], enc["blocks"]))
    B, S = MESH_TRAIN_STACK_SHAPE
    return dict(cfg=cfg, device=device, params=params,
                batches=[make_batch_for(cfg, S, B, 0)])


def mesh_train_stack_reference(torch, inp) -> None:
    """The meshless bundle's float32 step on `inp`'s masters and batch in
    this process, into inp["ref"]: loss, grad norm, lr and wall ms, and
    the state after the step, for the ranks to hold their shards against
    (the meshless bf16 step, printed only, was cut for the script's
    time)."""
    import dev_train_torch as dtt
    from repro_torch.common.config import TrainConfig
    from repro_torch.runtime import train as train_rt

    ref = {}
    for dt in ("float32",):
        bundle = train_rt.make_bundle(
            dataclasses.replace(inp["cfg"], dtype=dt),
            TrainConfig(**MESH_TRAIN_TCFG))
        state = dtt.global_state(inp["params"], inp["device"])
        if inp["device"] == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = bundle.step_fn(state, inp["batches"][0])
        r = dict(loss=float(m["loss"]),
                 ms=(time.perf_counter() - t0) * 1e3,
                 gnorm=float(m["grad_norm"]), lr=float(m["lr"]))
        if dt == "float32":
            r["state"] = state
        ref[dt] = r
        del state, bundle
    inp["ref"] = ref
    if inp["device"] == "cuda":
        torch.cuda.empty_cache()


def mesh_train_stack_four(inp) -> tuple:
    """The dp2tp2 ranks' call for one stack, under deterministic
    algorithms: a float32 step held against the meshless float32 state
    of `mesh_train_stack_reference`, then a bf16 step (printed)."""
    import dev_train_torch as dtt

    f32 = inp["ref"]["float32"]
    return (dtt.mesh_train_rank, (
        inp["cfg"], 2, 2, inp["params"], inp["batches"],
        [dict(name="f32", dtype="float32", tcfg=MESH_TRAIN_TCFG,
              deterministic=True,
              compare=dict(state=f32["state"], lr_sum=f32["lr"])),
         dict(name="bf16", dtype="bfloat16", tcfg=MESH_TRAIN_TCFG,
              deterministic=True)], inp["device"]))


def mesh_train_stack_one(inp) -> tuple:
    """The (1, 1) rank's call for one stack: a bf16 step under
    deterministic algorithms beside the meshless bundle's step in the
    rank's process."""
    import dev_train_torch as dtt

    return (dtt.mesh_train_rank, (
        inp["cfg"], 1, 1, inp["params"], inp["batches"],
        [dict(name="bf16 (1, 1)", dtype="bfloat16", tcfg=MESH_TRAIN_TCFG,
              deterministic=True, against_meshless=True)], inp["device"]))


def mesh_train_stack_gates(arch, inp, four, gate, one=None) -> None:
    """Prints and gates one stack's mesh train runs (`four`: each dp2tp2
    rank's [f32, bf16] runs; `one`: the (1, 1) rank's run, where it ran):
    the float32 loss and grad norm within 1e-5 relative of the meshless
    float32 step, every shard after it against the meshless state
    (updates within 1e-2 lr on 99.9% of a leaf's elements and 2.2 lr
    everywhere, moments 1e-4 of their max), replicas bit-equal, a rank's
    state bytes its spec share, MESH_TRAIN_STACK_KERNELS launched on
    every rank and no plain version; (1, 1) bit-equal. The bf16 loss
    and the wall ms are printed only."""
    import dev_train_torch as dtt

    cfg, ref32 = inp["cfg"], inp["ref"]["float32"]
    want = MESH_TRAIN_STACK_KERNELS[arch]
    B, S = MESH_TRAIN_STACK_SHAPE
    enc = (f" + {cfg.num_encoder_layers} encoder"
           if cfg.num_encoder_layers else "")
    print(f"  mesh train {cfg.name}: {cfg.num_layers}{enc} layers (depth "
          f"cut), d {cfg.d_model}, vocab {cfg.vocab_size}; batch {B} x {S}"
          f"{f' + {cfg.num_prefix_tokens} patches' if cfg.num_prefix_tokens else ''}"
          f", remat block, seed-0 float32 masters; meshless float32 loss "
          f"{ref32['loss']} grad norm {ref32['gnorm']} ({ref32['ms']:.1f} "
          f"ms)")
    f32, bf16 = [r[0] for r in four], [r[1] for r in four]
    for name, runs in (("f32", f32), ("bf16", bf16)):
        bad = dtt.replicas_equal([r["digests"] for r in runs])
        sizes = {(r["state_bytes"], r["share_bytes"]) for r in runs}
        print(f"  mesh train {arch} dp2tp2 {name}: replicas bit-equal "
              f"{not bad} {bad[:4]}; state bytes a rank / spec share "
              f"{sorted(sizes)}")
        gate(not bad, f"mesh train {arch} {name}: replicas differ {bad[:4]}")
        gate(all(a == b for a, b in sizes),
             f"mesh train {arch} {name}: state bytes {sorted(sizes)}")
        for r in runs:
            gate(all(r["launches"].get(k, 0) > 0 for k in want)
                 and not r["plain"], f"mesh train {arch} {name} rank "
                 f"{r['coord']}: launches {r['launches']} plain {r['plain']}")
    for r in f32:
        d_loss = abs(r["losses"][0] - ref32["loss"]) / abs(ref32["loss"])
        d_norm = abs(r["grad_norms"][0] - ref32["gnorm"]) / ref32["gnorm"]
        c = r["compare"]
        peak = ("not measured" if r["peak_gb"] is None
                else f"{r['peak_gb']:.2f} GB")
        print(f"    rank {r['coord']} f32: loss rel err {d_loss:.2e}, grad "
              f"norm {d_norm:.2e}; state vs meshless: updates within 1e-2 "
              f"lr on {c['update_share']:.5f} of the worst leaf, worst "
              f"{c['update_err_over_lr']:.3e} lr, moments "
              f"{c['moment_err']:.2e} of their max; "
              f"{r['step_ms'][0]:.1f} ms a step wall; peak {peak}; "
              f"launches {r['launches']}")
        gate(d_loss <= 1e-5 and d_norm <= 1e-5,
             f"mesh train {arch} f32 rank {r['coord']}: loss {d_loss}, "
             f"grad norm {d_norm}")
        gate(c["update_share"] >= 0.999 and c["update_err_over_lr"] <= 2.2
             and c["moment_err"] <= 1e-4 and c["counts_equal"],
             f"mesh train {arch} f32 rank {r['coord']}: state {c}")
    ms = [r["step_ms"][0] for r in bf16]
    print(f"  mesh train {arch} dp2tp2 bf16 (printed only): loss "
          f"{bf16[0]['losses'][0]}, |mesh bf16 - meshless float32| "
          f"{abs(bf16[0]['losses'][0] - ref32['loss']):.3e}; wall ms a "
          f"step {min(ms):.1f}-{max(ms):.1f} over the ranks (gloo through "
          f"host memory, 4 ranks on one card); launches rank 0 "
          f"{bf16[0]['launches']}")
    gate(len({tuple(r["losses"]) for r in bf16}) == 1,
         f"mesh train {arch} bf16: the ranks' losses differ")
    if one is not None:
        m = one["meshless"]
        print(f"  mesh train {arch} (1, 1) nccl bf16, deterministic: loss "
              f"{one['losses']} grad norm {one['grad_norms']} vs the "
              f"meshless bundle's {m['steps']} in the rank's process: equal "
              f"{m['steps_equal']}; state leaves bit-equal "
              f"{m['leaves_equal']} of {m['leaves']}; "
              f"{one['step_ms'][0]:.1f} ms a step wall; launches "
              f"{one['launches']} plain {one['plain']}")
        gate(m["steps_equal"] and m["leaves_equal"] == m["leaves"],
             f"mesh train {arch} (1, 1): not bit-equal to the meshless "
             "bundle")
        gate(all(one["launches"].get(k, 0) > 0 for k in want)
             and not one["plain"], f"mesh train {arch} (1, 1): launches "
             f"{one['launches']} plain {one['plain']}")


def moe_grad_gate(torch, per, moe_params, x, cot, cfg, gate,
                  device="cuda") -> None:
    """`moe_ep`'s gradients on the dp2tp2 ranks (`per`: each rank's
    `dev_train_torch.moe_grad_rank` result, expert weights split under
    the training rules) against `moe_dense`'s on the card: every weight's
    and x's within 1e-4 of their largest entry, y and aux too."""
    import numpy as np

    import dev_train_torch as dtt
    from repro_torch.models import moe

    w = {k: torch.tensor(v, device=device, requires_grad=True)
         for k, v in moe_params.items()}
    xt = torch.tensor(x, device=device, requires_grad=True)
    y, aux = moe.moe_dense(w, xt, cfg)
    dtt.moe_objective(y, aux, torch.tensor(cot, device=device),
                      n_aux=2).backward()
    got = per[0]
    print(f"  kernels moe_ep grads x {tuple(x.shape)}: none (moe_ep's "
          f"products are PyTorch's, as the reference's are jnp einsums)")
    errs = {"y": (got["y"], y.detach().cpu().numpy()),
            "x": (got["x_grad"], xt.grad.cpu().numpy())}
    errs.update({k: (got["grads"][k], w[k].grad.cpu().numpy()) for k in w})
    rel = {k: float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
           for k, (a, b) in errs.items()}
    aux_err = abs(got["aux"] - float(aux.detach()))
    print(f"  moe_ep grads at {cfg.name}'s widths, x {tuple(x.shape)} "
          f"(sequence split over the EP axis: {x.shape[1] % 2 == 0}; capacity "
          f"{cfg.capacity_factor}, expert weights {got['specs']}): err / max "
          f"{ {k: f'{v:.2e}' for k, v in rel.items()} }, aux err "
          f"{aux_err:.2e}; {max(p['ms'] for p in per):.1f} ms forward + "
          f"backward (gloo)")
    gate(max(rel.values()) <= 1e-4 and aux_err <= 1e-4,
         f"moe_ep grads: {rel}, aux {aux_err}")


SSD_CUT_TP = 32          # the witness's ranks: mamba2-780m over tp 32


def ssd_cut_witness(torch) -> list:
    """One process's witness of a head cut over SSD_CUT_TP ranks
    (ROADMAP A16f): one mamba2-780m layer (published widths, seed-0
    float32 weights) gives its meshless scan inputs for a 128-token
    prompt (`models.ssm.scan_inputs`); each rank's block of `d_inner`
    (96 of 3072 channels, 1.5 heads) runs through the kernel as the
    virtual heads `models.ssm.virtual_heads` gives it (the helper the
    block's `_rank_params` uses), and the ranks' y and final states,
    concatenated on the channels, must equal the meshless kernel's scan
    within 1e-5 of their largest magnitude (float32). Returns the
    failures; prints the errors and the kernel's launches."""
    from repro_torch import configs, kernels
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.models import model as M
    from repro_torch.models import ssm
    from repro_torch.models.module import layer_slice

    cfg = dataclasses.replace(configs.get("mamba2_780m"), num_layers=1,
                              dtype="float32")
    gen = torch.Generator("cuda").manual_seed(0)
    p = layer_slice(M.init_model(cfg, gen)["blocks"]["pos0"], 0)["ssm"]
    x = torch.randn((1, 128, cfg.d_model), generator=gen, device="cuda")
    with torch.no_grad():
        xs, _, Bm, Cm, dt, A, _ = ssm.scan_inputs(p, x)
        B_, S_ = xs.shape[:2]
        H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        bc = (Bm.reshape(B_, S_, 1, N), Cm.reshape(B_, S_, 1, N))
        y, h = sops.ssd(xs.reshape(B_, S_, H, P), dt, A, *bc, p["D"],
                        impl="cuda")
        di = cfg.d_inner // SSD_CUT_TP
        ys, hs = [], []
        n0 = kernels.LAUNCHES["ssd_scan"]
        for r in range(SSD_CUT_TP):
            g, heads = ssm.virtual_heads(cfg, di, r)
            idx = torch.tensor(heads, device="cuda")
            yr, hr = sops.ssd(
                xs[..., r * di:(r + 1) * di].reshape(B_, S_, di // g, g),
                dt[..., idx], A[idx], *bc, p["D"][idx], impl="cuda")
            ys.append(yr.reshape(B_, S_, di))
            hs.append(hr.reshape(B_, di, N))
        launches = kernels.LAUNCHES["ssd_scan"] - n0
    y_cut = torch.cat(ys, -1).reshape(y.shape)
    h_cut = torch.cat(hs, 1).reshape(h.shape)
    err_y = float((y_cut - y).abs().max() / y.abs().max())
    err_h = float((h_cut - h).abs().max() / h.abs().max())
    print(f"  ssd_scan head cut witness: mamba2-780m layer 0 (seed 0), "
          f"{SSD_CUT_TP} ranks of {di} channels ({g}-channel virtual heads)"
          f", {launches} launches, vs the meshless scan: y err / max "
          f"{err_y:.3e}, state {err_h:.3e} (gate 1e-5)")
    ok = err_y <= 1e-5 and err_h <= 1e-5 and launches == SSD_CUT_TP
    return [] if ok else [f"ssd_scan head cut witness: y {err_y}, state "
                          f"{err_h}, launches {launches}"]


def shard_shape_cases(torch, timer) -> list:
    """The mesh phase's kernels at the shapes one rank of granite-3-2b on
    dp2tp2 gives them (16 of 32 query heads, 4 of 8 KV heads, D 64):
    flash_mha over a 128-token admission (B 1, causal); flash_mha and its
    backward at a rank's train shard (B 4 of the batch of 8, S 256, bf16;
    the backward within 2e-2 of the largest grad of the plain chunked
    backward, timed beside SDPA's backward); paged_flash_decode over 4
    of the 8 slots (int8 per-page pool, 16-token pages, 16 pages a slot);
    one admission's grouped write_pages (k,
    k_sz, v, v_sz over 40 layers, 128 rows); ssd_scan over a 128-token
    admission on a rank's 24 of mamba2-780m's 48 heads, and on the
    virtual heads of a rank whose block of `d_inner` cuts a head (ROADMAP
    A16f: 3 of 32 at tp 32, 3 of 16 at tp 64), with the 32-rank witness
    (`ssd_cut_witness`); flash_decode_lse on seamless-m4t-large-v2's
    contiguous cross-KV shard (2 slots, every one of its 16 heads at 64
    of 128 encoder positions); flash_decode over granite's contiguous
    caches of 255 positions, whole over `model` (4 slots, the rank's 16
    heads against their 4 KV heads). Each is held
    against its plain version (float32 atol=rtol=1e-5, bf16 atol=2e-2,
    the write bit for bit; ssd_scan against its plain version evaluated
    in float64 at the ssd sweep's tolerances; the lse at LSE_TOL) and
    timed in bf16 beside its bound, its plain version and the library
    call that computes the same function (SDPA; SDPA on the dequantized
    pages, the gather excluded; `index_copy_` x4; none for ssd_scan).
    Returns the records."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.page_io import ops as pops

    F = torch.nn.functional

    gen = torch.Generator("cuda").manual_seed(3)
    failures, records = [], []

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    def check(name, case, out, ref, tol):
        err, ok = max_err(torch, out, ref, tol)
        print(f"  {'ok  ' if ok else 'FAIL'} {name:18s} shard {case} "
              f"max_abs_err={err:.3e}")
        if not ok:
            failures.append(f"{name} {case}")
        return err

    def record(name, case, kernel, plain, lib, bytes_, ops_, err):
        t_b, t_o = bytes_ / HBM_BYTES_PER_S, ops_ / PEAK_OPS["bfloat16"]
        rec = dict(name=name, case=case, ms=timer(kernel),
                   plain_ms=timer(plain), library_ms=lib(),
                   bound_ms=max(t_b, t_o) * 1e3,
                   bound_by="bytes" if t_b >= t_o else "operations",
                   max_abs_err=err)
        print(f"  mesh shard {name:18s} {case}: kernel {rec['ms']:.4f} ms "
              f"plain {rec['plain_ms']:.4f} ms library {rec['library_ms']} "
              f"ms bound {rec['bound_ms']:.5f} ms ({rec['bound_by']})")
        records.append(rec)

    def sdpa(q, k, v):
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        try:
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=True)
        except TypeError:          # torch without enable_gqa
            return None
        return timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))

    H, KV, D, page = 16, 4, 64, 16
    # --- flash_mha: one admission of 128 tokens on the rank's heads ---
    for dt in (torch.float32, torch.bfloat16):
        q = randn(1, 128, H, D, dtype=dt)
        k = randn(1, 128, KV, D, dtype=dt)
        v = randn(1, 128, KV, D, dtype=dt, scale=0.5)
        err = check("flash_mha", f"B=1 S=128 H={H} KV={KV} D={D} "
                    f"{str(dt)[6:]}", fops.mha(q, k, v, impl="cuda"),
                    fops.mha(q, k, v, impl="reference"),
                    F32_TOL if dt == torch.float32 else BF16_TOL)
    ops_, bytes_ = fops.mha_cost(q.shape, k.shape, causal=True,
                                 itemsize=2)
    record("flash_mha", f"bf16 B=1 S=128 H={H} KV={KV} D={D} causal; "
           "library = SDPA", lambda: fops.mha(q, k, v, impl="cuda"),
           lambda: fops.mha(q, k, v, impl="reference"),
           lambda: sdpa(q, k, v), bytes_, ops_, err)

    # --- flash_mha and its backward at a rank's train shard -------------
    from repro_torch.kernels.flash_attention import chunked
    from repro_torch.kernels.flash_attention import flash_attention as fa

    Bt, St = 4, 256
    q = randn(Bt, St, H, D, dtype=torch.bfloat16)
    k = randn(Bt, St, KV, D, dtype=torch.bfloat16)
    v = randn(Bt, St, KV, D, dtype=torch.bfloat16, scale=0.5)
    do = randn(Bt, St, H, D, dtype=torch.bfloat16)
    case = f"bf16 B={Bt} S={St} H={H} KV={KV} D={D} causal (train shard)"
    err = check("flash_mha", case, fops.mha(q, k, v, impl="cuda"),
                fops.mha(q, k, v, impl="reference"), BF16_TOL)
    ops_, bytes_ = fops.mha_cost(q.shape, k.shape, causal=True, itemsize=2)
    record("flash_mha", f"{case}; library = SDPA",
           lambda: fops.mha(q, k, v, impl="cuda"),
           lambda: fops.mha(q, k, v, impl="reference"),
           lambda: sdpa(q, k, v), bytes_, ops_, err)
    out, lse4 = chunked._fwd(q, k, v, True, None, 0, 512, 512)
    lse = lse4.reshape(Bt, H, St).contiguous()
    got = fa.flash_mha_bwd_cuda(q, k, v, out, lse, do, causal=True)
    want = chunked._bwd_inner(True, None, 0, 512, 512, (q, k, v, out, lse4),
                              do)
    rel = max(float((g.float() - w_.float()).abs().max())
              / max(float(w_.float().abs().max()), 1e-30)
              for g, w_ in zip(got, want))
    err = max(float((g.float() - w_.float()).abs().max())
              for g, w_ in zip(got, want))
    print(f"  {'ok  ' if rel <= 2e-2 else 'FAIL'} flash_mha_bwd      shard "
          f"{case} max_abs_err={err:.3e} err/max {rel:.3e}")
    if rel > 2e-2:
        failures.append(f"flash_mha_bwd {case}")
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))

    def sdpa_bwd():
        try:
            o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True)
        except TypeError:          # torch without enable_gqa
            return None
        return timer(functools.partial(torch.autograd.grad, o, (qt, kt, vt),
                                       do.transpose(1, 2),
                                       retain_graph=True))

    ops_, bytes_ = fops.mha_bwd_cost(q.shape, k.shape, causal=True,
                                     itemsize=2)
    record("flash_mha_bwd", f"{case}; library = SDPA backward",
           lambda: fa.flash_mha_bwd_cuda(q, k, v, out, lse, do, causal=True),
           lambda: chunked._bwd_inner(True, None, 0, 512, 512,
                                      (q, k, v, out, lse4), do),
           sdpa_bwd, bytes_, ops_, err)
    del q, k, v, do, out, lse, lse4, got, want, qt, kt, vt

    # --- paged_flash_decode: the rank's 4 slots on its int8 pool -------
    B, n_pages = 4, 16
    P = 8 * n_pages
    lens = torch.tensor([70, 100, 140, 160], dtype=torch.int32,
                        device="cuda")
    bt = torch.stack([torch.randperm(P, generator=gen, device="cuda")
                      [:n_pages] for _ in range(B)]).to(torch.int32)
    kp, vp = (torch.randint(-127, 128, (P, page, KV, D), generator=gen,
                            device="cuda", dtype=torch.int8)
              for _ in range(2))
    szs = {n: torch.stack([0.005 + 0.015 * torch.rand(
        (P, KV), generator=gen, device="cuda"), torch.rand(
        (P, KV), generator=gen, device="cuda") - 0.5], -1)
        for n in ("k_sz", "v_sz")}
    for dt in (torch.float32, torch.bfloat16):
        q = randn(B, H, D, dtype=dt)
        err = check("paged_flash_decode", f"B={B} H={H} KV={KV} D={D} int8 "
                    f"q={str(dt)[6:]}",
                    dops.paged_decode_mha(q, kp, vp, bt, lens, impl="cuda",
                                          **szs),
                    dops.paged_decode_mha(q, kp, vp, bt, lens,
                                          impl="reference", **szs),
                    F32_TOL if dt == torch.float32 else BF16_TOL)
    n_keys = int(lens.sum())
    n_reads = int((-(-lens // page)).sum())
    kd = dref.gather_pages_q8(kp, szs["k_sz"], bt).to(torch.bfloat16)
    vd = dref.gather_pages_q8(vp, szs["v_sz"], bt).to(torch.bfloat16)
    record("paged_flash_decode", f"bf16 q, int8/page pool B={B} H={H} "
           f"KV={KV} D={D} lengths={lens.tolist()}; library = SDPA, gather "
           "excluded",
           lambda: dops.paged_decode_mha(q, kp, vp, bt, lens, impl="cuda",
                                         **szs),
           lambda: dops.paged_decode_mha(q, kp, vp, bt, lens,
                                         impl="reference", **szs),
           lambda: sdpa_decode_ms(torch, timer, q, kd, vd, lens),
           2 * n_keys * KV * D + 2 * n_reads * KV * 2 * 4
           + 2 * q.numel() * 2 + n_reads * 4 + B * 4,
           4 * D * H * n_keys, err)

    # --- write_pages: one admission of 128 rows on the rank's heads ----
    nb, n_wp = 40, 8
    phys = torch.randperm(P, generator=gen, device="cuda")[:n_wp].to(
        torch.int32)
    specs = [((page, KV, D), torch.int8), ((KV, 2), torch.float32)] * 2

    def leaf(n, shape, dt):
        if dt == torch.int8:
            return torch.randint(-127, 128, (nb, n, *shape), generator=gen,
                                 device="cuda", dtype=torch.int8)
        return randn(nb, n, *shape, dtype=dt)

    pools = [leaf(P, s_, dt) for s_, dt in specs]
    tiles = [leaf(n_wp, s_, dt) for s_, dt in specs]
    want = [p_.clone() for p_ in pools]
    pops.write_pages_group(want, tiles, phys, impl="reference")
    got = [p_.clone() for p_ in pools]
    pops.write_pages_group(got, tiles, phys, impl="cuda")
    ok = all(torch.equal(a, b) for a, b in zip(got, want))
    print(f"  {'ok  ' if ok else 'FAIL'} write_pages        shard k,k_sz,"
          f"v,v_sz nb={nb} KV={KV} D={D} {n_wp * page} rows: bit-equal {ok}")
    if not ok:
        failures.append("write_pages shard")
    phys64 = phys.long()
    record("write_pages", f"int8 admission k,k_sz,v,v_sz nb={nb} KV={KV} "
           f"D={D} {n_wp * page} rows; library = index_copy_ x4",
           lambda: pops.write_pages_group(pools, tiles, phys, impl="cuda"),
           lambda: pops.write_pages_group(pools, tiles, phys,
                                          impl="reference"),
           lambda: timer(lambda: [p_.index_copy_(1, phys64, t_)
                                  for p_, t_ in zip(pools, tiles)]),
           sum(2 * t_.numel() * t_.element_size() for t_ in tiles)
           + n_wp * 4, 0, 0.0)
    del pools, tiles, want, got

    # --- ssd_scan: a 128-token mamba2-780m admission on a rank's heads --
    from repro_torch.kernels.ssd_scan import chunked
    from repro_torch.kernels.ssd_scan import ops as sops

    Hs, Ps, Ns, Ss = 24, 64, 128, 128

    def ssd_inputs(dt, H=Hs, P=Ps):
        def rn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")

        return (rn(1, Ss, H, P).to(dt), F.softplus(rn(1, Ss, H)),
                -torch.exp(rn(H) * 0.5), rn(1, Ss, 1, Ns).to(dt),
                rn(1, Ss, 1, Ns).to(dt), rn(H), None)

    def ssd_case(label, H, P, note):
        """ssd_scan at (B 1, S Ss, H heads of P, N Ns) against its plain
        version in float64, float32 and bf16, then timed in bf16."""
        for dt in (torch.float32, torch.bfloat16):
            args = ssd_inputs(dt, H, P)
            y, h = sops.ssd(*args, impl="cuda")
            y64, h64 = chunked.ssd_chunked(
                *(None if a_ is None else a_.double() for a_ in args),
                chunk=128)
            case = f"B=1 S={Ss} H={H} P={P} N={Ns} {str(dt)[6:]}"
            err = check("ssd_scan", case, y, y64.to(y.dtype),
                        dict(atol=2e-4, rtol=2e-4) if dt == torch.float32
                        else dict(atol=2e-2, rtol=8e-3))
            check("ssd_scan", f"{case} state", h, h64,
                  dict(atol=2e-4, rtol=2e-4))
        n_ops, nbytes = sops.ssd_cost(args[0].shape, args[3].shape,
                                      itemsize=2, b_itemsize=2, has_D=True,
                                      has_init=False)
        record("ssd_scan", f"bf16 B=1 S={Ss} H={H}{label} P={P} N={Ns} "
               f"({note}); library = none: no single PyTorch call "
               "computes the chunked SSD",
               lambda: sops.ssd(*args, impl="cuda"),
               lambda: chunked.ssd_chunked(*args), lambda: None, nbytes,
               n_ops, err)

    ssd_case(" of 48", Hs, Ps, "a dp2tp2 rank's heads of mamba2-780m, one "
             "128-token admission")
    # a head cut across ranks (ROADMAP A16f): mamba2-780m over tp 32 (a
    # rank's 96 of 3072 channels, 1.5 heads: 3 virtual heads of 32) and
    # tp 64 (48 channels: 3 virtual heads of 16)
    for P_v, tp_v in ((32, 32), (16, 64)):
        ssd_case(" virtual", 3, P_v, f"head cut: a tp-{tp_v} rank of "
                 "mamba2-780m, one 128-token admission")
    failures.extend(ssd_cut_witness(torch))

    # --- flash_decode_lse: seamless's contiguous cross-KV shard --------
    # every head at the rank's 64 of 128 encoder positions, every key
    # live, for its 2 of the 4 slots; q gathered whole over tp
    Bc, Hc, Dc, Sc = 2, 16, 64, 64
    lens = torch.full((Bc,), Sc, dtype=torch.int32, device="cuda")
    for dt in (torch.float32, torch.bfloat16):
        q = randn(Bc, Hc, Dc, dtype=dt)
        k = randn(Bc, Sc, Hc, Dc, dtype=dt)
        v = randn(Bc, Sc, Hc, Dc, dtype=dt, scale=0.5)
        out, lse = dops.decode_mha(q, k, v, lens, impl="cuda",
                                   return_lse=True)
        ref, ref_lse = dops.decode_mha(q, k, v, lens, impl="reference",
                                       return_lse=True)
        case = f"B={Bc} H={Hc} KV={Hc} D={Dc} S_loc={Sc} {str(dt)[6:]}"
        err = check("flash_decode_lse", case, out, ref,
                    F32_TOL if dt == torch.float32 else BF16_TOL)
        check("flash_decode_lse", f"{case} lse", lse, ref_lse, LSE_TOL)
    ops_, bytes_ = dops.decode_cost(q.shape, k.shape, int(lens.sum()),
                                    q.element_size(), lse=True)
    record("flash_decode_lse", f"bf16 B={Bc} H={Hc} KV={Hc} D={Dc} "
           f"S_loc={Sc} all live (seamless-m4t-large-v2's contiguous "
           "cross-KV shard on a dp2tp2 rank: every head at 64 of 128 "
           "encoder positions); library = SDPA with a length mask",
           lambda: dops.decode_mha(q, k, v, lens, impl="cuda",
                                   return_lse=True),
           lambda: dops.decode_mha(q, k, v, lens, impl="reference",
                                   return_lse=True),
           lambda: sdpa_decode_ms(torch, timer, q, k, v, lens), bytes_, ops_,
           err)
    # --- flash_decode: granite's contiguous caches of 255, whole --------
    # (ROADMAP A16f) a dp2tp2 rank's 4 slots decode every one of the 32
    # query heads (gathered over model) against the whole cache's 8 KV
    # heads, read in place, over every position a slot has (prompts of
    # 64-128 tokens plus up to 32 decoded); the rank keeps its 16 heads
    Bw, Hw, KVw, Dw, Sw = 4, 32, 8, 64, 255
    lens = torch.tensor([96, 160, 129, 65], dtype=torch.int32,
                        device="cuda")
    for dt in (torch.float32, torch.bfloat16):
        q = randn(Bw, Hw, Dw, dtype=dt)
        k = randn(Bw, Sw, KVw, Dw, dtype=dt)
        v = randn(Bw, Sw, KVw, Dw, dtype=dt, scale=0.5)
        case = f"B={Bw} H={Hw} KV={KVw} D={Dw} S={Sw} {str(dt)[6:]}"
        err = check("flash_decode", case,
                    dops.decode_mha(q, k, v, lens, impl="cuda"),
                    dops.decode_mha(q, k, v, lens, impl="reference"),
                    F32_TOL if dt == torch.float32 else BF16_TOL)
    ops_, bytes_ = dops.decode_cost(q.shape, k.shape, int(lens.sum()),
                                    q.element_size())
    record("flash_decode", f"bf16 B={Bw} H={Hw} KV={KVw} D={Dw} S={Sw} "
           "lengths 65-160 (granite-3-2b's contiguous caches of 255 on a "
           "dp2tp2 rank, whole over model: every query head, gathered, "
           "against every KV head); library = SDPA with a length mask",
           lambda: dops.decode_mha(q, k, v, lens, impl="cuda"),
           lambda: dops.decode_mha(q, k, v, lens, impl="reference"),
           lambda: sdpa_decode_ms(torch, timer, q, k, v, lens), bytes_, ops_,
           err)
    if failures:
        raise AssertionError(f"mesh shard shapes: {failures}")
    return records


def mesh_phase(torch, timer):
    """Serving on a mesh (`ServingEngine.build(..., mesh=mesh)` over a
    `DeviceMesh` with its default context and serving rules, one process
    per rank, `dev_serve_torch.mesh_rank`): granite-3-2b at published
    widths (d 2048, 32 / 8 heads, head_dim 64, ff 8192, vocab 49155;
    seeded random weights, float32 masters; its depth cut to
    MESH_SERVE_LAYERS = 8 of its 40 layers for serving) on the
    engine phase's bucket cell (8 slots, max_seq 256, buckets 64 / 128,
    16-token pages; half the pool local, so pages move through the
    substrate) over 8 chat requests of 32 new tokens.

    First the kernels at one dp2tp2 rank's shard shapes
    (`shard_shape_cases`). Then, at once (each engine is host-bound and
    the card mostly idle, so every wall tok/s is taken beside the
    others): the meshless engine in this process (float32 fp and int8
    pools, bf16 int8), and the spawned ranks, which take this process's
    float32 masters by CUDA IPC:
    * (1, 1) on NCCL, one spawned rank, bf16 int8 (the main path): its
      tokens and every pool leaf bit-equal to the meshless engine's; the
      same for bf16 on the contiguous layout (no merge over tp 1);
    * dp2tp2 as 4 ranks sharing the card over gloo (NCCL refuses two
      ranks of one communicator on one GPU; gloo moves the collectives'
      bytes through host memory, so their times are not NCCL's), every
      tensor and kernel on the card: float32 fp tokens of every rank
      equal each other's and the meshless engine's, float32 int8 at
      least INT8_TOKEN_AGREEMENT of the meshless int8 engine's; the data
      replicas of each pool bit-equal; each rank's
      pool half the meshless pool's bytes; placement gap 0 on every
      rank; flash_mha, write_pages and paged_flash_decode launched on
      every rank, no plain version; the wall tok/s printed; bf16: the
      last-token logits of every prompt's prompt pass on the ranks'
      shards no further from the meshless bf16 pass than that is from
      the meshless float32 pass (the ssm phase's rule; random deep bf16
      stacks flip tokens on one-ulp differences, so the bf16 engine's
      tokens are not gated), the float32 drift printed; the contiguous
      layout (`paged=False`, ROADMAP A16c: slots over `data`, each
      slot's positions over `model`, flash_decode with its lse and the
      ranks' merge): float32 tokens of every rank equal the meshless
      contiguous engine's, each rank a quarter of its caches,
      flash_mha and flash_decode_lse launched on every rank, no plain
      version; the serve bundle's last decode-step logits over 64
      prefilled + 4 decoded positions (`dev_serve_torch.bundle_logits`:
      every step merges both ranks' blocks) no further from the meshless
      bundle's in bf16 than bf16 is from float32; caches of 255
      positions (ROADMAP A16f: the extent does not divide over `model`,
      so every rank holds them whole and decodes every query head,
      gathered, with flash_decode, keeping its own, no lse, no merge):
      float32 tokens of every rank equal the meshless engine's, each
      rank half the caches, flash_mha and flash_decode launched
      (flash_decode once a layer a decode step) and flash_decode_lse not
      at all;
    * on the same ranks, `moe_ep` at granite-moe-1b-a400m's widths (d
      1024, 32 experts, top 8, ff 512; EP over `model`), x (4, 128,
      1024) float32: with capacity 8.0 no pair drops and y is within 1e-4
      of `moe_dense` (relative to its largest entry), aux within 1e-4;
      with the config's capacity the dispatch drops pairs (some on some
      rank, y finite) and their count is printed.
    Training on the same ranks, after their serving runs (ROADMAP A16b,
    `runtime.train.make_bundle(mesh=)`; granite-3-2b cut to
    MESH_TRAIN_LAYERS layers, batch 8 x 256, remat block, the seed-0
    float32 masters' first layers by CUDA IPC; `mesh_train_gates`):
    * (1, 1) on NCCL: two bf16 steps under deterministic algorithms bit-
      equal (loss, grad norm, every state leaf) to the meshless bundle's
      in the rank's process;
    * dp2tp2: two float32 steps, loss and grad norm within 1e-5 of the
      meshless float32 steps taken here, every shard after them against
      the meshless state (updates within 1e-2 lr on 99.9% of a leaf's
      elements and 2.2 lr everywhere, moments 1e-4 of their max),
      `compressed_psum` over the first step's grads (error state bit-equal
      to a plain recomputation, mean within its quantization bound), the
      tiered step bit-equal to the untiered; two bf16 steps whose loss
      stays no further from the meshless bf16 loss than that is from
      float32; replicas bit-equal, a rank's state bytes its spec share,
      flash_mha and its backward launched on every rank, no plain
      version; `moe_ep`'s gradients at granite-moe's widths (capacity
      8.0, the training rules' layout) within 1e-4 of `moe_dense`'s, at
      x (4, 128, 1024) and at an odd sequence, x (2, 127, 1024), which
      does not split over the EP axis (ROADMAP A16f).
    The other stacks on the same ranks after those runs (ROADMAP A16d;
    MESH_STACKS, 4 chat requests of 16 new tokens on 4 slots, their
    float32 masters by CUDA IPC):
    * mamba2-780m (4 of 48 layers) and seamless-m4t-large-v2 (4 + 4
      layers) at published widths: dp2tp2 float32 paged fp and
      contiguous tokens of every rank equal the meshless engine's, each
      rank a quarter of the meshless slot-resident bytes (SSM state and
      conv tails; the cross-KV), the data replicas of seamless's pool
      bit-equal, MESH_STACK_KERNELS launched on every rank (ssd_scan;
      flash_decode_lse by the contiguous cross-attention) and no plain
      version, the bf16 prompt pass on the ranks' shards no further from
      the meshless bf16 pass than that is from float32; (1, 1) on NCCL,
      bf16 int8: tokens, pool and resident leaves bit-equal;
    * ngram speculation (k 4) on granite's float32 weights over dp2tp2:
      every rank's tokens equal the greedy mesh engine's on the same
      requests, the verify steps equal across ranks.
    The other stacks' training on the same ranks, last (ROADMAP A16e;
    MESH_TRAIN_STACKS at published widths, depth cut: mamba2-780m 2 of
    48 layers, paligemma-3b 2 of 18 with its 256 patches, seamless 2 + 2;
    one step of batch 4 x 128, remat block; `mesh_train_stack_gates`):
    * dp2tp2 float32: loss and grad norm within 1e-5 of the meshless
      float32 step taken here, every shard after it against the meshless
      state (the rule above), replicas bit-equal, a rank's state bytes
      its spec share, ssd_scan (mamba2) or flash_mha and its backward
      launched on every rank, no plain version; bf16: the loss drift
      from meshless bf16 and the wall ms printed only;
    * (1, 1) on NCCL, mamba2 bf16 under deterministic algorithms: loss,
      grad norm and every state leaf bit-equal to the meshless bundle.
    Returns the launches of rank 0's float32 int8 run, of its float32
    contiguous run (flash_decode_lse) and of its float32 train run."""
    import numpy as np

    import dev_serve_torch as dst
    import dev_train_torch as dtt
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.models.module import cast_params
    from repro_torch.serving import Request, ServingEngine, make_scenario

    print(f"mesh on {smi_line()}")
    t_mesh = time.perf_counter()

    def since():
        return f"{time.perf_counter() - t_mesh:.1f} s into the phase"

    shard_records = shard_shape_cases(torch, timer)
    print(f"  shard shapes done, {since()}")
    cfg = dataclasses.replace(configs.get(MESH_ARCH),
                              num_layers=MESH_SERVE_LAYERS)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    print(f"mesh {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"H={cfg.num_heads}/{cfg.num_kv_heads} hd={cfg.head_dim} "
          f"ff={cfg.d_ff} vocab={cfg.vocab_size} "
          f"({cfg.param_count() / 1e9:.2f} B params), random weights seed 0")
    trace = make_scenario("chat", 8, cfg.vocab_size, seed=0,
                          prompt_buckets=(64, 128), gen_range=(32, 32),
                          arrival_rate=1e5)
    prompts = [r.tokens for r in trace]
    failures = []

    def gate(ok, what):
        if not ok:
            print(f"  FAIL {what}")
            failures.append(what)

    # the ranks take the float32 masters drawn here from seed 0 (the draws
    # `ServingEngine.build` makes) by CUDA IPC, and each rank's `build`
    # cuts its shard; the
    # (1, 1) NCCL rank, the 4 dp2tp2 gloo ranks and this process's
    # meshless engine run at once (the phase's time: the card is mostly
    # idle, each engine host-bound), so every wall tok/s below is taken
    # beside the others
    params = M.init_model(cfg, torch.Generator("cuda").manual_seed(0))
    mcfg = dataclasses.replace(configs.get("granite_moe_1b_a400m"),
                               dtype="float32")
    rng = np.random.default_rng(0)
    d, E, ff = mcfg.d_model, mcfg.num_experts, mcfg.moe_d_ff
    moe_params = {k: rng.normal(0, sc, shape).astype(np.float32)
                  for k, shape, sc in (("router", (d, E), d ** -0.5),
                                       ("w_gate", (E, d, ff), d ** -0.5),
                                       ("w_up", (E, d, ff), d ** -0.5),
                                       ("w_down", (E, ff, d), ff ** -0.5))}
    x = rng.normal(0, 1, (4, 128, d)).astype(np.float32)
    cot = rng.normal(0, 1, (4, 128, d)).astype(np.float32)
    x_odd, cot_odd = (rng.normal(0, 1, (*MOE_ODD_SHAPE, d)).astype(
        np.float32) for _ in range(2))
    cases = [(dataclasses.replace(mcfg, capacity_factor=c or
                                  mcfg.capacity_factor), None, "rowcol")
             for _, c in MOE_CAPS]
    runs = [dict(MESH_CELL, **r) for r in MESH_RUNS]
    # the other stacks and the speculative engine: 4 chat requests of 16
    # new tokens each, float32 masters drawn here from seed 0
    stacks = {}
    for arch, cut in MESH_STACKS.items():
        acfg = dataclasses.replace(configs.get(arch), **cut)
        cell = dict(MESH_STACK_CELL, prefill_buckets=MESH_STACK_BUCKETS[arch])
        stacks[arch] = dict(
            cfg=acfg, cell=cell,
            params=M.init_model(acfg, torch.Generator("cuda").manual_seed(0)),
            prompts=[r.tokens for r in make_scenario(
                "chat", 4, acfg.vocab_size, seed=0,
                prompt_buckets=MESH_STACK_BUCKETS[arch], gen_range=(16, 16),
                arrival_rate=1e5)])
        print(f"mesh {acfg.name}: {acfg.num_layers}"
              f"{f' + {acfg.num_encoder_layers}' if acfg.num_encoder_layers else ''}"
              f" layers (depth cut), d={acfg.d_model} "
              + (f"SSM heads {acfg.ssm_heads} of {acfg.ssm_head_dim} state "
                 f"{acfg.ssm_state}" if acfg.sub_quadratic else
                 f"H={acfg.num_heads}/{acfg.num_kv_heads} ff={acfg.d_ff}")
              + f" vocab={acfg.vocab_size}, 4 chat requests x 16 tokens on "
              f"buckets {MESH_STACK_BUCKETS[arch]}")
    spec_cell = dict(MESH_CELL, n_slots=4)
    spec_prompts = prompts[:4]
    # the other stacks' training (ROADMAP A16e): mamba2's and seamless's
    # masters are their serving masters' first layers
    train_stacks = {arch: mesh_train_stack_inputs(
        torch, arch, stacks[arch]["params"] if arch in stacks else None)
        for arch in MESH_TRAIN_STACKS}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        # the (1, 1) rank starts at once; the dp2tp2 ranks after the
        # meshless train steps, whose float32 states they compare with
        train_inp = mesh_train_inputs(cfg, params)
        f_one = pool.submit(
            mesh_mod.run_ranks, dst.mesh_calls, 1,
            ([(dst.mesh_rank, (cfg, 1, 1, params, prompts, 32,
                               [dict(r, **MESH_CELL) for r in ONE_RUNS],
                               "cuda")),
              mesh_train_one(train_inp)]
             + [(dst.mesh_rank, (st["cfg"], 1, 1, st["params"],
                                 st["prompts"], 16,
                                 [dict(MESH_STACK_MAIN, **st["cell"])],
                                 "cuda")) for st in stacks.values()]
             + [mesh_train_stack_one(train_stacks[MESH_TRAIN_STACK_ONE])],),
            device="cuda", backend="nccl", wall_s=600, threads=1)
        t_train = time.perf_counter()
        mesh_train_reference(torch, train_inp)
        for inp in train_stacks.values():
            mesh_train_stack_reference(torch, inp)
        print(f"  meshless train steps done, {since()} "
              f"({time.perf_counter() - t_train:.1f} s)")
        f_four = pool.submit(
            mesh_mod.run_ranks, dst.mesh_calls, 4,
            ([(dst.mesh_rank, (cfg32, 2, 2, params, prompts, 32, runs,
                               "cuda")),
              (dst.mesh_moe_rank, (2, 2, moe_params, x, cases, "cuda")),
              mesh_train_four(train_inp),
              (dtt.moe_grad_rank, (2, 2, moe_params, x, cot,
                                   dataclasses.replace(
                                       mcfg, capacity_factor=8.0),
                                   "cuda"))]
             + [(dst.mesh_rank, (dataclasses.replace(st["cfg"],
                                                     dtype="float32"),
                                 2, 2, st["params"], st["prompts"], 16,
                                 [dict(r, **st["cell"])
                                  for r in MESH_STACK_RUNS], "cuda"))
                for st in stacks.values()]
             + [(dst.mesh_rank, (cfg32, 2, 2, params, spec_prompts, 16,
                                 [dict(r, **spec_cell)
                                  for r in MESH_SPEC_RUNS], "cuda"))]
             + [mesh_train_stack_four(inp)
                for inp in train_stacks.values()]
             + [(dtt.moe_grad_rank, (2, 2, moe_params, x_odd, cot_odd,
                                     dataclasses.replace(
                                         mcfg, capacity_factor=8.0),
                                     "cuda"))],),
            device="cuda", backend="gloo", wall_s=900, threads=1)

        # --- the meshless engine, this process ------------------------
        ref = {}
        for i, run in enumerate((*MESH_RUNS, MAIN_RUN, CONTIG_BF16)):
            rcfg = dataclasses.replace(cfg, dtype=run["dtype"])
            ecfg = dst.mesh_ecfg(8, 128, 32, pool_dtype=run["pool_dtype"],
                                 paged=run.get("paged", True),
                                 **dict(MESH_CELL, max_seq=run.get(
                                     "max_seq", MESH_CELL["max_seq"])))
            eng = ServingEngine.build(rcfg, ecfg, params=params)
            reqs = [Request(request_id=j, tokens=p, max_new_tokens=32,
                            arrival=0.0) for j, p in enumerate(prompts)]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            eng.run(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            ref[i] = dict(tokens=np.stack([np.asarray(r.output)
                                           for r in reqs]),
                          digests=dst.pool_digests(eng.caches),
                          pool_bytes=dst.pool_nbytes(eng.caches),
                          wall_s=wall)
            print(f"  meshless {run['name']}: {8 * 32} tokens in {wall:.2f} "
                  f"s ({8 * 32 / wall:.1f} tok/s wall, beside the ranks), "
                  f"pool {ref[i]['pool_bytes'] / 1e6:.2f} MB")
            del eng
            torch.cuda.empty_cache()      # the ranks share the card
        logits = {dt: dst.prompt_logits(cfg, cast_params(params, dt),
                                        prompts, dt, "cuda")
                  for dt in ("float32", "bfloat16")}
        for arch, st in stacks.items():
            st["ref"] = {}
            for run in (*MESH_STACK_RUNS, MESH_STACK_MAIN):
                rcfg = dataclasses.replace(st["cfg"], dtype=run["dtype"])
                ecfg = dst.mesh_ecfg(4, max(map(len, st["prompts"])), 16,
                                     pool_dtype=run["pool_dtype"],
                                     paged=run.get("paged", True),
                                     **st["cell"])
                eng = ServingEngine.build(rcfg, ecfg, params=st["params"])
                reqs = [Request(request_id=j, tokens=p, max_new_tokens=16,
                                arrival=0.0)
                        for j, p in enumerate(st["prompts"])]
                eng.run(reqs)
                st["ref"][run["name"]] = dict(
                    tokens=np.stack([np.asarray(r.output) for r in reqs]),
                    digests=dst.pool_digests(eng.caches),
                    pool_bytes=dst.pool_nbytes(eng.caches),
                    resident_digests=dst.resident_digests(eng.caches),
                    resident_bytes=dst.resident_nbytes(eng.caches))
                del eng
                torch.cuda.empty_cache()
            st["logits"] = {dt: dst.prompt_logits(
                st["cfg"], cast_params(st["params"], dt), st["prompts"],
                dt, "cuda") for dt in ("float32", "bfloat16")}
            print(f"  meshless {arch} runs done, {since()}")
        dec_logits = {dt: dst.bundle_logits(cfg, params, dt, "cuda")
                      for dt in ("float32", "bfloat16")}
        torch.cuda.empty_cache()
        print(f"  meshless runs done, {since()}; this process holds "
              f"{torch.cuda.memory_reserved() / 1e9:.1f} GB of the card")
        one_all = f_one.result()[0]
        (one, one_c), one_t = one_all[0], one_all[1][0]
        print(f"  (1, 1) done, {since()} (mesh built in "
              f"{one['mesh_s']:.1f} s)")
        got = f_four.result()
    build_s = [round(max(g[0][i]["build_s"] for g in got), 1)
               for i in range(len(runs))]
    print(f"  dp2tp2 gloo: 4 ranks spawned, served and joined in "
          f"{time.perf_counter() - t0:.1f} s (mesh built in "
          f"{max(g[0][0]['mesh_s'] for g in got):.1f} s; each run's "
          f"`ServingEngine.build`, the shard cut included, {build_s} s)")
    del params
    for st in stacks.values():
        del st["params"]
    torch.cuda.empty_cache()

    # --- training on the mesh -------------------------------------------
    train_launches = mesh_train_gates(train_inp, one_t, [g[2] for g in got],
                                      gate)
    moe_grad_gate(torch, [g[3] for g in got], moe_params, x, cot,
                  dataclasses.replace(mcfg, capacity_factor=8.0), gate)
    # S 127 on the EP axis of 2: the sequence does not split over it
    moe_grad_gate(torch, [g[-1] for g in got], moe_params, x_odd, cot_odd,
                  dataclasses.replace(mcfg, capacity_factor=8.0), gate)
    del train_inp
    # the other stacks' training (ROADMAP A16e), after the speculative
    # runs in each rank's calls; the (1, 1) rank's last call
    n_stack_train = 5 + len(stacks)
    for j, (arch, inp) in enumerate(train_stacks.items()):
        mesh_train_stack_gates(
            arch, inp, [g[n_stack_train + j] for g in got], gate,
            one_all[-1][0] if arch == MESH_TRAIN_STACK_ONE else None)
    del train_stacks
    torch.cuda.empty_cache()
    print(f"  mesh train gates done, {since()}")

    # --- (1, 1) on NCCL: the main path, bit-equal ----------------------
    i_main = len(MESH_RUNS)
    same = np.array_equal(one["tokens"], ref[i_main]["tokens"])
    print(f"  (1, 1) nccl bf16 int8: tokens equal {same}, pool leaves "
          f"bit-equal {one['digests'] == ref[i_main]['digests']} "
          f"({len(one['digests'])} leaves), launches {one['launches']}, "
          f"plain {one['plain']}, {8 * 32 / one['wall_s']:.1f} tok/s wall")
    gate(same and one["digests"] == ref[i_main]["digests"],
         "(1, 1): tokens or pool leaves differ from the meshless engine")
    gate(all(one["launches"].get(k, 0) > 0 for k in BUCKET_KERNELS)
         and not one["plain"], f"(1, 1): launches {one['launches']}")
    # the contiguous layout: with tp 1 no merge runs, the plain decode
    i_c = i_main + 1
    same = np.array_equal(one_c["tokens"], ref[i_c]["tokens"])
    print(f"  (1, 1) nccl bf16 contiguous: tokens equal {same}, cache "
          f"leaves bit-equal {one_c['digests'] == ref[i_c]['digests']} "
          f"({len(one_c['digests'])} leaves), launches "
          f"{one_c['launches']}, plain {one_c['plain']}, "
          f"{8 * 32 / one_c['wall_s']:.1f} tok/s wall on {smi_line()}")
    gate(same and one_c["digests"] == ref[i_c]["digests"],
         "(1, 1) contiguous: tokens or cache leaves differ from the "
         "meshless engine")
    gate(all(one_c["launches"].get(k, 0) > 0 for k in ("flash_mha",
                                                       "flash_decode"))
         and not one_c["plain"], f"(1, 1) contiguous: launches "
         f"{one_c['launches']}")

    # --- dp2tp2 over gloo, 4 ranks on the card, and moe_ep -------------
    results = [g[0] for g in got]
    bad = dst.mesh_gates(results, {i: ref[i]["tokens"] for i in ref},
                         {i: ref[i]["pool_bytes"] for i in ref}, 2, runs,
                         cfg.num_kv_heads % 2 == 0)
    for b in bad:
        gate(False, f"dp2tp2 {b}")
    for i, run in enumerate(MESH_RUNS):
        per = [r[i] for r in results]
        agree = dst.compare(per[0]["tokens"], ref[i]["tokens"])
        tok_s = [8 * 32 / p["wall_s"] for p in per]
        print(f"  dp2tp2 {run['name']}: vs meshless {agree}; "
              f"ranks' tokens equal "
              f"{all(np.array_equal(p['tokens'], per[0]['tokens']) for p in per)}"
              f"; data replicas equal per model shard; pool "
              f"{per[0]['pool_bytes'] / 1e6:.2f} MB a rank vs "
              f"{ref[i]['pool_bytes'] / 1e6:.2f} meshless; placement gaps "
              f"{[p['placement_gap'] for p in per]} ({per[0]['substrate']})"
              f"; wall tok/s {min(tok_s):.1f}-{max(tok_s):.1f} (gloo through"
              f" host memory, 4 ranks on one card) vs meshless "
              f"{8 * 32 / ref[i]['wall_s']:.1f}")
        paged = run.get("paged", True)
        want = (BUCKET_KERNELS if paged else CONTIG_WHOLE_KERNELS
                if run is CONTIG_WHOLE else CONTIG_KERNELS)
        for r, p in enumerate(per):
            print(f"    rank {r} {p['coord']}: launches {p['launches']} "
                  f"plain {p['plain']}")
            gate(all(p["launches"].get(k, 0) > 0 for k in want)
                 and not p["plain"], f"dp2tp2 {run['name']} rank {r}: "
                 f"launches {p['launches']}, plain {p['plain']}")
        if run is CONTIG_WHOLE:
            # every layer's decode in every step is one flash_decode
            steps = {p["summary"]["steps"] for p in per}
            n_dec = {p["launches"].get("flash_decode", 0) for p in per}
            print(f"  kernels dp2tp2 {run['name']} (caches of 255 whole over"
                  f" model; every query head gathered, no merge): "
                  f"flash_mha and flash_decode, launches a rank "
                  f"{sorted(n_dec)} for {sorted(steps)} decode steps x "
                  f"{cfg.num_layers} layers; flash_decode_lse "
                  f"{[p['launches'].get('flash_decode_lse', 0) for p in per]}"
                  f"; cache bytes a rank {per[0]['pool_bytes'] / 1e6:.2f} MB"
                  f" vs {ref[i]['pool_bytes'] / 1e6:.2f} meshless")
            gate(len(steps) == 1 and n_dec == {cfg.num_layers * steps.pop()}
                 and not any("flash_decode_lse" in p["launches"]
                             for p in per),
                 f"dp2tp2 {run['name']}: flash_decode launches {n_dec}, "
                 f"lse {[p['launches'].get('flash_decode_lse') for p in per]}")
        gate(per[0]["substrate"] == ("physical" if paged else "off"),
             f"dp2tp2 {run['name']}: substrate {per[0]['substrate']}")
        if run.get("decode_logits"):
            d32, d16 = (max(float(np.abs(p["decode_logits"][dt]
                                         - dec_logits[dt]).max())
                            for p in per)
                        for dt in ("float32", "bfloat16"))
            d_dtype = float(np.abs(dec_logits["bfloat16"]
                                   - dec_logits["float32"]).max())
            print(f"  dp2tp2 serve bundle, last decode step's logits (8 "
                  f"sequences, 64 prefilled + 4 decoded in caches of 128: "
                  f"each step merges both ranks' blocks; max |logit| "
                  f"{float(np.abs(dec_logits['float32']).max()):.2f}): mesh"
                  f" vs meshless in float32 {d32:.3e}, in bf16 {d16:.4f}, "
                  f"meshless bf16 vs float32 {d_dtype:.4f} (gate: bf16 "
                  f"drift <= the dtype's) on {smi_line()}")
            gate(d16 <= d_dtype, f"dp2tp2 contiguous bf16 decode drift "
                 f"{d16} > the bf16 dtype drift {d_dtype}")
        if run.get("logits"):
            d32, d16 = (max(float(np.abs(p["logits"][dt]
                                         - logits[dt]).max()) for p in per)
                        for dt in ("float32", "bfloat16"))
            d_dtype = float(np.abs(logits["bfloat16"]
                                   - logits["float32"]).max())
            flips = int((per[0]["logits"]["bfloat16"].argmax(-1)
                         != logits["bfloat16"].argmax(-1)).sum())
            print(f"  dp2tp2 prompt pass, last-token logits of the 8 "
                  f"prompts (max |logit| "
                  f"{float(np.abs(logits['float32']).max()):.2f}): mesh vs "
                  f"meshless in float32 {d32:.3e}, in bf16 {d16:.4f} "
                  f"({flips} first tokens differ), meshless bf16 vs "
                  f"float32 {d_dtype:.4f} (gate: bf16 drift <= the "
                  "dtype's)")
            gate(d16 <= d_dtype, f"dp2tp2 bf16 drift {d16} > the bf16 "
                 f"dtype drift {d_dtype}")
    print(f"  dp2tp2 done, {since()}")

    # --- the other stacks over the mesh (ROADMAP A16d) -------------------
    n_fixed = 4                 # granite, moe_ep, train, moe grads
    for j, (arch, st) in enumerate(stacks.items()):
        acfg, ref_s = st["cfg"], st["ref"]
        one_s, main = one_all[2 + j][0], ref_s[MESH_STACK_MAIN["name"]]
        same = np.array_equal(one_s["tokens"], main["tokens"])
        bits = (one_s["digests"] == main["digests"]
                and one_s["resident_digests"] == main["resident_digests"])
        print(f"  (1, 1) nccl {acfg.name} bf16 int8: tokens equal {same}, "
              f"pool and resident leaves bit-equal {bits} "
              f"({len(one_s['digests'])} + {len(one_s['resident_digests'])}"
              f" leaves), launches {one_s['launches']}, plain "
              f"{one_s['plain']}")
        gate(same and bits, f"(1, 1) {arch}: tokens or leaves differ from "
             "the meshless engine")
        gate(all(one_s["launches"].get(k, 0) > 0
                 for k in MESH_STACK_KERNELS[arch][True])
             and not one_s["plain"], f"(1, 1) {arch}: launches "
             f"{one_s['launches']}, plain {one_s['plain']}")
        s_runs = [dict(r, **st["cell"]) for r in MESH_STACK_RUNS]
        per_run = [g[n_fixed + j] for g in got]
        bad = dst.mesh_gates(
            per_run, {i: ref_s[r["name"]]["tokens"]
                      for i, r in enumerate(MESH_STACK_RUNS)},
            {i: ref_s[r["name"]]["pool_bytes"]
             for i, r in enumerate(MESH_STACK_RUNS)}, 2, s_runs,
            acfg.num_kv_heads % 2 == 0,
            {i: ref_s[r["name"]]["resident_bytes"]
             for i, r in enumerate(MESH_STACK_RUNS)})
        for b_ in bad:
            gate(False, f"dp2tp2 {arch} {b_}")
        for i, run in enumerate(MESH_STACK_RUNS):
            per = [r[i] for r in per_run]
            paged = run.get("paged", True)
            ref_r = ref_s[run["name"]]
            tok_s = [4 * 16 / p_["wall_s"] for p_ in per]
            print(f"  dp2tp2 {acfg.name} {run['name']}: vs meshless "
                  f"{dst.compare(per[0]['tokens'], ref_r['tokens'])}; "
                  f"resident {per[0]['resident_bytes'] / 1e6:.3f} MB a "
                  f"rank vs {ref_r['resident_bytes'] / 1e6:.3f} meshless, "
                  f"pool {per[0]['pool_bytes'] / 1e6:.2f} MB a rank vs "
                  f"{ref_r['pool_bytes'] / 1e6:.2f}; wall tok/s "
                  f"{min(tok_s):.1f}-{max(tok_s):.1f} (gloo)")
            for r, p_ in enumerate(per):
                print(f"    rank {r} {p_['coord']}: launches "
                      f"{p_['launches']} plain {p_['plain']}")
                gate(all(p_["launches"].get(k, 0) > 0
                         for k in MESH_STACK_KERNELS[arch][paged])
                     and not p_["plain"], f"dp2tp2 {arch} {run['name']} "
                     f"rank {r}: launches {p_['launches']}, plain "
                     f"{p_['plain']}")
            if run.get("logits"):
                lg = st["logits"]
                d32, d16 = (max(float(np.abs(p_["logits"][dt]
                                             - lg[dt]).max()) for p_ in per)
                            for dt in ("float32", "bfloat16"))
                d_dtype = float(np.abs(lg["bfloat16"]
                                       - lg["float32"]).max())
                print(f"  dp2tp2 {acfg.name} prompt pass, last-token logits "
                      f"of the 4 prompts (max |logit| "
                      f"{float(np.abs(lg['float32']).max()):.2f}): mesh vs "
                      f"meshless in float32 {d32:.3e}, in bf16 {d16:.4f}, "
                      f"meshless bf16 vs float32 {d_dtype:.4f} (gate: bf16 "
                      f"drift <= the dtype's)")
                gate(d16 <= d_dtype, f"dp2tp2 {arch} bf16 drift {d16} > "
                     f"the bf16 dtype drift {d_dtype}")
    # --- ngram speculation on granite over the mesh ---------------------
    per_spec = [g[n_fixed + len(stacks)] for g in got]
    greedy, ngram = ([r[i] for r in per_spec] for i in range(2))
    same = all(np.array_equal(p_["tokens"], greedy[0]["tokens"])
               for p_ in (*greedy, *ngram))
    steps = sorted({p_["spec_steps"] for p_ in ngram})
    print(f"  dp2tp2 {cfg.name} ngram k=4 f32 fp, 4 requests x 16 tokens: "
          f"tokens of every rank equal the greedy mesh engine's {same} "
          f"({dst.compare(ngram[0]['tokens'], greedy[0]['tokens'])}); "
          f"verify steps {steps} for 15 decoded tokens a request; "
          f"launches rank 0 {ngram[0]['launches']}, plain "
          f"{ngram[0]['plain']}")
    gate(same and len(steps) == 1 and 0 < steps[0],
         f"dp2tp2 ngram: tokens equal {same}, verify steps {steps}")
    gate(all(p_["launches"].get(k, 0) > 0 for p_ in ngram
             for k in BUCKET_KERNELS) and not any(p_["plain"]
                                                   for p_ in ngram),
         "dp2tp2 ngram: launches or plain calls")
    print(f"  stacks and speculation done, {since()}")
    tparams = {k: torch.from_numpy(v).cuda() for k, v in moe_params.items()}
    xt = torch.from_numpy(x).cuda()
    for (label, _), case, *per in zip(MOE_CAPS, cases,
                                      *[g[1] for g in got]):
        y, aux = moe.moe_dense(tparams, xt, case[0])
        y = y.cpu().numpy()
        err = float(np.abs(per[0]["y"] - y).max() / np.abs(y).max())
        aux_err = abs(per[0]["aux"] - float(aux))
        dropped = sum(p["dropped"] for p in per)
        print(f"  moe_ep {mcfg.name} widths d={d} E={E} top "
              f"{mcfg.experts_per_token} ff={ff}, x (4, 128, {d}) f32, "
              f"capacity {case[0].capacity_factor} ({label}): dropped "
              f"pairs {dropped}; vs moe_dense: y rel err {err:.3e}, aux "
              f"err {aux_err:.3e}; {per[0]['wall_s'] * 1e3:.1f} ms a call "
              f"(gloo)")
        if label == "no drops":
            gate(dropped == 0 and err < 1e-4 and aux_err < 1e-4,
                 f"moe_ep: dropped {dropped}, y {err}, aux {aux_err}")
        else:
            gate(dropped > 0 and all(np.isfinite(p["y"]).all() for p in per),
                 f"moe_ep at the config's capacity: dropped {dropped}")
    for rec in shard_records:
        if "head cut" in rec["case"]:
            print(f"  {rec['name']}: {rec['ms']:.4f} ms at a head cut's "
                  f"shard shape ({rec['case']}); no mesh here cuts a head "
                  "(the witness above runs the cut's shapes)")
            continue
        # (which rank result, which run, its label) holds the launches of
        # the shard shape's kernel on the main path
        src, i, label = {
            "ssd_scan": (n_fixed, 0, "mamba2 f32 fp"),
            "flash_decode_lse": (n_fixed + 1, 1, "seamless f32 contiguous"),
            "flash_decode": (0, MESH_RUNS.index(CONTIG_WHOLE),
                             "granite f32 contiguous 255"),
        }.get(rec["name"], (0, 1, "granite f32 int8"))
        if "train shard" in rec["case"]:
            src, i, label = 2, 1, "granite bf16 train"
        per_rank = [g[src][i]["launches"].get(rec["name"]) for g in got]
        print(f"  {rec['name']}: launches a rank in the {label} run "
              f"{per_rank}, {rec['ms']:.4f} ms at the shard shape "
              f"({rec['case']})")
    if failures:
        raise AssertionError(f"mesh phase: {failures}")
    out = {k: results[0][1]["launches"].get(k, 0) for k in BUCKET_KERNELS}
    out["flash_decode_lse"] = results[0][MESH_RUNS.index(CONTIG_F32)][
        "launches"].get("flash_decode_lse", 0)
    out["flash_mha_bwd"] = train_launches.get("flash_mha_bwd", 0)
    return out


# kernel groups of the profiled runs: (group, substrings a lowercased
# kernel name must all hold); the two decode kernels share one template
# body, whose row policy (PagedRows / DenseRows) names which one ran
PROFILE_GROUPS = (
    ("paged_flash_decode", ("decode_split_kernel", "pagedrows")),
    ("flash_decode", ("decode_split_kernel", "denserows")),
    ("flash_mha", ("flash_mma_kernel",)),
    ("flash_mha", ("flash_combine_kernel",)),
    ("flash_mha", ("flash_fma_kernel",)),
    ("flash_mha_bwd", ("flash_bwd_",)),
    ("write_pages/page_out/page_in", ("page_copy_kernel",)),
    ("paged_prefill_flash/insert_flash/insert_flash_q8", ("paged_prefill",)),
    ("ssd_scan", ("ssd_mma_kernel",)),
    ("ssd_scan", ("ssd_fma_kernel",)),
    ("matmul_w8a8", ("matmul_w8a8_mma_kernel",)),
)
# kernels whose every instantiation the build phase lists (registers and
# spills)
LISTED_KERNELS = ("flash_mma_kernel", "flash_combine_kernel",
                  "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                  "flash_bwd_dq_mma_kernel", "flash_bwd_dkv_mma_kernel",
                  "decode_split_kernel", "ssd_mma_kernel",
                  "matmul_w8a8_mma_kernel")


def profile_run(torch, eng, reqs, label="int8 kernels run") -> dict:
    """Serve `reqs` under torch.profiler and print where the time goes
    (`profile_calls`). Returns the device ns by kernel group."""
    return profile_calls(torch, lambda: eng.run(reqs), label,
                         lambda stats: f"over {stats.steps} decode steps")


def profile_calls(torch, fn, label, describe=lambda out: "") -> dict:
    """Run `fn` under torch.profiler and print where the time goes:
    the device's busy share of the run's wall time (union of device
    intervals), device time by kernel group, the host's busiest ops by
    total CPU time and the host syncs; `describe(fn's result)` adds to
    the first line. Returns the device ns by kernel group
    (`PROFILE_GROUPS`). It reads the profiler's raw event list: building
    its event tree takes minutes for a trace this long. Profiling slows
    the host, so the run's wall time here is longer than the unprofiled
    run's."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    t1 = time.perf_counter()
    raw = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    kern = sorted((e.start_ns(), e.end_ns(), e.name().lower()) for e in raw
                  if e.device_type() == cuda)
    busy_ns, end = 0, float("-inf")
    for s0, s1, _ in kern:
        if s1 > end:
            busy_ns += s1 - max(s0, end)
            end = s1
    busy = busy_ns / 1e3 / wall_us
    by_group: dict = {}
    for s0, s1, name in kern:
        g = next((grp for grp, subs in PROFILE_GROUPS
                  if all(x in name for x in subs)), None)
        if g is None:
            g = "matmul" if any(w in name for w in (
                "gemm", "nvjet", "cutlass", "cublas")) else "other"
        by_group[g] = by_group.get(g, 0) + (s1 - s0)
    host: dict = {}
    syncs = 0
    for e in raw:
        if e.device_type() != cuda:
            name = e.name()
            host[name] = host.get(name, 0) + e.duration_ns()
            syncs += "synchronize" in name or name == "aten::nonzero"
    top = sorted(host.items(), key=lambda kv: kv[1], reverse=True)[:6]
    total_ns = sum(by_group.values()) or 1
    print(f"  profile {label}: wall {wall_us / 1e3:.1f} ms "
          f"{describe(out)}, device busy {busy:.3f} of wall "
          f"(idle {1 - busy:.3f}); device ms by group " + json.dumps(
              {k: round(v / 1e6, 3) for k, v in sorted(by_group.items())})
          + "; share of device time " + json.dumps(
              {k: round(v / total_ns, 4)
               for k, v in sorted(by_group.items())}))
    print("  profile host ops by total CPU ms: " + json.dumps(
        {k: round(v / 1e6, 1) for k, v in top})
        + f"; nonzero/sync calls {syncs}; {len(raw)} events read in "
        f"{time.perf_counter() - t1:.1f} s")
    return by_group


# ---------------------------------------------------------------- main
PHASES = ("device", "build", "kernels", "quantify", "engine", "substrate",
          "prefetch", "fleet", "chunked", "contiguous", "speculative", "ssm",
          "archs", "train", "launch", "tiering", "dryrun", "mesh")


def parse_phases(argv) -> set:
    """`--phases a,b,...` (default: all). `device` always runs: the last
    line names the card; `dryrun` brings `tiering` (its gate holds the
    dry-run's units to that phase's launches)."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ", ".join(PHASES))
    names = {p for p in ap.parse_args(argv).phases.split(",") if p}
    unknown = names - set(PHASES)
    if unknown:
        ap.error(f"unknown phase(s) {sorted(unknown)}; known: "
                 f"{', '.join(PHASES)}")
    if "dryrun" in names:
        names.add("tiering")
    return names | {"device"}


def main(argv=None) -> int:
    phases = parse_phases(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = smi_line()
    print(f"device: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"devices={torch.cuda.device_count()}; phases "
          f"{[p for p in PHASES if p in phases]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build

    # the dry-run needs no card: it runs on the cores the build leaves idle
    dry = start_dryrun() if "dryrun" in phases else None
    dry_records = None
    t_phase = time.perf_counter()

    def phase_done(name):
        nonlocal t_phase
        now = time.perf_counter()
        print(f"phase {name}: {now - t_phase:.1f} s")
        t_phase = now

    if "build" in phases:
        paths = build.build_all()
        print(f"build: {len(paths)} libraries in {build.LAST_BUILD_S:.1f} s")
        for name, path in paths.items():
            log = path.with_suffix(".log").read_text().splitlines()
            regs = [line for line in log if "registers" in line]
            spills = [line for line in log if "spill" in line
                      and " 0 bytes spill stores" not in line]
            print(f"  {name}: {len(regs)} kernels; "
                  f"{regs[-1].strip() if regs else ''}; "
                  f"{len(spills)} with spills")
            for i, line in enumerate(log):
                if "spill" not in line:
                    continue
                mangled = log[i - 1].split("for ")[-1].strip()
                listed = any(k in mangled for k in LISTED_KERNELS)
                if listed or " 0 bytes spill stores" not in line:
                    fn = demangle(mangled)
                    used = log[i + 1].strip() if i + 1 < len(log) else ""
                    print(f"    {'spills in ' if not listed else ''}{fn}: "
                          f"{line.strip()}; {used}")
        phase_done("build")
    if dry is not None:
        # nothing is timed on the card while the dry-run holds the cores
        dry_records = finish_dryrun(dry)
        phase_done("dryrun --all")
    records = []
    if "kernels" in phases:
        records = kernel_cases(torch, Timer(torch))
        phase_done("kernels")
    launches = {}
    if "quantify" in phases:
        launches.update(quantify_phase(torch))
        phase_done("quantify")
    if "engine" in phases:
        launches.update(engine_phase(torch))
        phase_done("engine")
    if "substrate" in phases:
        launches.update(substrate_phase(torch))
        phase_done("substrate")
    if "prefetch" in phases:
        pf_launches, record = prefetch_phase(torch, Timer(torch))
        records.append(record)
        launches.update(pf_launches)
        phase_done("prefetch")
    if "fleet" in phases:
        launches.update(fleet_phase(torch))
        phase_done("fleet")
    if "chunked" in phases:
        launches.update(chunked_phase(torch))
        phase_done("chunked")
    if "contiguous" in phases:
        launches.update(contiguous_phase(torch))
        phase_done("contiguous")
    if "speculative" in phases:
        # paged_prefill_flash now runs inside the engine: its launches
        # come from the int8 speculative run, not the chunk cell
        launches.update(speculative_phase(torch))
        phase_done("speculative")
    if "ssm" in phases:
        launches.update(ssm_phase(torch))
        phase_done("ssm")
    if "archs" in phases:
        # the earlier phases' counts stand for the kernels they drive
        for k, v in archs_phase(torch).items():
            launches.setdefault(k, v)
        phase_done("archs")
    if "train" in phases:
        train_launches, record = train_phase(torch, Timer(torch))
        records.append(record)
        # the serving phases' counts stand for the forward kernels
        for k, v in train_launches.items():
            launches.setdefault(k, v)
        launches["flash_mha_bwd"] = train_launches["flash_mha_bwd"]
        phase_done("train")
    if "launch" in phases:
        for k, v in launch_phase(torch).items():
            launches.setdefault(k, v)
        phase_done("launch")
    tier_launches = {}
    if "tiering" in phases:
        tier_launches = tiering_phase(torch, Timer(torch))
        for k, v in tier_launches.items():
            launches.setdefault(k, v)
        phase_done("tiering")
    if "dryrun" in phases:
        dryrun_phase(torch, tier_launches, dry_records)
        phase_done("dryrun")
    if "mesh" in phases:
        # the ranks' counts stand for no kernel another phase counted
        for k, v in mesh_phase(torch, Timer(torch)).items():
            launches.setdefault(k, v)
        phase_done("mesh")
    for r in records:
        r["launches"] = launches.get(r["name"])
        r.pop("shape")
    if records:
        print(json.dumps({"kernels": records}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
