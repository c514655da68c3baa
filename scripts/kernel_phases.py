#!/usr/bin/env python3
"""Where a block's time goes in the flash-attention forward and
backward, split-decode, tensor-core SSD, W8A8 and grouped page-copy
kernels, on one card.

Instrumented copies of `csrc/flash_attention.cu`,
`csrc/flash_attention_bwd.cu` (the bf16 dq and dk/dv passes),
`csrc/decode_body.cuh`, `csrc/ssd_scan.cu`, `csrc/matmul_w8a8.cu` and
`csrc/page_io.cu` record, for every block, the global timer
(`%globaltimer`, ns) and the SM's cycle counter (`clock64`) at the end of each phase (thread 0), and
the SM it ran on. They run at the main shapes of PERF.md's kernel table:
flash_mha bf16 causal B=1, Sq=Skv=128, 15/5 heads, D=64 (the default
plan and 64-row blocks); flash_mha's backward at smollm-360m's train
shape, bf16 causal B=8, S=256, 15/5 heads, D=64 (its plan: 64 rows a dq
block, 16 keys a dk/dv block); paged decode B=8, int8/page, page 16, 16 pages,
lengths 70..257 (span 64 and 256, the latter without a split); the
contiguous decode B=8, S=256, bf16, lengths 129..160; at paligemma-3b's
shapes flash_mha B=1, S=384, 8/1 heads, D=256 and the paged decode B=8,
int8/page, 8/1 heads, D=256, lengths 320..400; the contiguous decode with
its lse at qwen2.5-32b's 16x16 rank (B=8, 40/8 heads, D=128, S=2048) and
a 16384-position block (B=1); ssd_scan's
tensor-core body bf16 B=1, S=128, 48 heads of 64, state 128 (the default
plan); matmul_w8a8 M=1024, K=960, N=2560 (the default plan); the page
copy at one SmolLM-360M admission (k, k_sz, v, v_sz of the int8 pool, 32
levels x 8 pages; grouped, and the payload and the 40-byte rows alone).
Each is
timed with the L2 flushed (as `chip_smoke.py` times kernels) and warm,
after 200 calls that bring the clocks up. Prints, per kernel and plan,
each phase's median and max over the blocks in microseconds and cycles,
the SM clock the two counters imply, the clocks nvidia-smi reads and the
card's name and power limit.

The copies are built with the flags of `kernels/build.py` into
`build/kernel_phases/` and loaded in place of the repository's libraries
inside this process only.

    python3 scripts/kernel_phases.py [--only flash,bwd_dq,bwd_dkv,decode,ssd,w8a8,page]

Needs a CUDA card and nvcc; exits 2 without a card."""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

OUT = ROOT / "build" / "kernel_phases"
CYCLES = 1 << 16          # row of the stamp table where cycle counts start
STAMPS = '''
__device__ unsigned long long* g_stamps;
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(k)                                                          \\
  do {                                                                    \\
    if (threadIdx.x == 0) {                                               \\
      const unsigned long long b_ =                                       \\
          blockIdx.x + gridDim.x * (blockIdx.y +                          \\
                                    (unsigned long long)gridDim.y *       \\
                                        blockIdx.z);                      \\
      g_stamps[b_ * 8 + (k)] = global_ns();                               \\
      g_stamps[(CYCLES_ROW + b_) * 8 + (k)] = clock64();                  \\
      if ((k) == 0) {                                                     \\
        unsigned sm_;                                                     \\
        asm volatile("mov.u32 %0, %%smid;" : "=r"(sm_));                  \\
        g_stamps[b_ * 8 + 7] = sm_;                                       \\
      }                                                                   \\
    }                                                                     \\
  } while (0)
extern "C" int phases_set(void* p) {
  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));
}
'''.replace("CYCLES_ROW", str(CYCLES))

# the backward's two kernels run in one call: the dk/dv kernel stamps
# its blocks from this row of the table on
BWD_DKV_ROW = 16384
STAMPS_BWD = STAMPS.replace("g_stamps[b_ * 8", "g_stamps[(kStampBase + b_) * 8") \
    .replace(f"g_stamps[({CYCLES} + b_) * 8",
             f"g_stamps[({CYCLES} + kStampBase + b_) * 8")

# (phase start stamp, end stamp, name) of each kernel
PHASES = {
    "flash": [(0, 1, "issue q and the first round's tiles"),
              (1, 2, "wait for them"),
              (2, 3, "products and softmax of round 0"),
              (3, 4, "later rounds, key groups' merge"),
              (4, 6, "write (warp 0)"),
              (0, 6, "whole block (warp 0)")],
    "bwd_dq": [(0, 1, "issue q, dO, O and key tile 0"),
               (1, 2, "wait for q, dO, O"),
               (2, 3, "delta"),
               (3, 4, "wait for tile 0 (issue tile 1)"),
               (4, 5, "every tile's products"),
               (5, 6, "write (warp 0)"),
               (0, 6, "whole block (warp 0)")],
    "bwd_dkv": [(0, 1, "issue K/V and the first row tile"),
                (1, 2, "wait for them"),
                (2, 3, "first tile's products"),
                (3, 4, "later tiles"),
                (4, 5, "row groups' merge"),
                (5, 6, "write (warp 0)"),
                (0, 6, "whole block (warp 0)")],
    "decode": [(0, 1, "length, table entries, q"),
               (1, 2, "first round's K/V and (scale, zero)"),
               (2, 3, "every round's products and softmax"),
               (3, 4, "partials and ticket"),
               (4, 6, "merge (last span block)"),
               (0, 6, "whole block (last or only span)")],
    "ssd": [(0, 1, "first chunk's copies"),
            (1, 2, "cumsum and decay weights (chunk 0)"),
            (2, 3, "C.B^T and C.state^T (chunk 0, warp 0)"),
            (3, 4, "decay, S.x and y write (chunk 0, warp 0)"),
            (4, 5, "barrier: the other warps (chunk 0)"),
            (5, 6, "later chunks and the state write"),
            (0, 6, "whole block")],
    "page": [(0, 4, "segment fields (parameter lookup)"),
             (4, 5, "source ids / vector width read"),
             (5, 1, "decode, first tile's loads issued"),
             (1, 2, "page ids staged (barrier)"),
             (2, 3, "first tile's data back, stores issued"),
             (3, 6, "later tiles"),
             (0, 6, "whole block")],
    "w8a8": [(0, 1, "first K tile's copies"),
             (1, 3, "ldmatrix and mma (tile 0, warp 0)"),
             (3, 4, "later K tiles"),
             (4, 6, "epilogue (warp 0)"),
             (0, 6, "whole block")],
}


def _insert(text: str, anchor: str, stamp: str, after: bool = True) -> str:
    if text.count(anchor) < 1:
        raise RuntimeError(f"kernel_phases: anchor not found: {anchor!r}")
    return text.replace(anchor, anchor + stamp if after else stamp + anchor,
                        1)


def flash_source(csrc: Path) -> str:
    s = (csrc / "flash_attention.cu").read_text()
    s = _insert(s, '#include "mma.cuh"\n', STAMPS)
    head, body = s.split("flash_mma_kernel(", 1)
    body, tail = body.split("// merge the n_split partial", 1)
    body = _insert(body, "  const int tid = threadIdx.x;", "  STAMP(0);\n",
                   after=False)
    body = _insert(body, "  repro::cp_async_commit();\n\n  const int n_rounds",
                   "  STAMP(1);\n\n", after=False)
    body = _insert(body, "    __syncthreads();  // round r (and, first, q) "
                   "landed for every thread\n", "    if (r == 0) STAMP(2);\n")
    body = _insert(body, "    __syncthreads();  // round r's slots free for "
                   "reuse\n", "    if (r == 0) STAMP(3);\n")
    body = _insert(body, "#pragma unroll\n  for (int h = 0; h < 2; ++h) {\n"
                   "    if (!row_ok[h]) continue;", "  STAMP(4);\n",
                   after=False)
    i = body.rindex("}\n")
    body = body[:i] + "  STAMP(6);\n" + body[i:]
    return head + "flash_mma_kernel(" + body + "// merge the n_split partial" \
        + tail


def bwd_source(csrc: Path) -> str:
    s = (csrc / "flash_attention_bwd.cu").read_text()
    s = _insert(s, '#include "mma.cuh"\n', STAMPS_BWD)
    head, dq = s.split("flash_bwd_dq_mma_kernel(", 1)
    dq, dkv = dq.split("flash_bwd_dkv_mma_kernel(", 1)
    dkv, tail = dkv.split("struct Args {", 1)
    dq = _insert(dq, "  const int tid = threadIdx.x;",
                 "  constexpr int kStampBase = 0;\n  STAMP(0);\n",
                 after=False)
    dq = _insert(dq, "  if (n_tiles > 0) issue(0);\n"
                 "  repro::cp_async_commit();\n", "  STAMP(1);\n")
    dq = _insert(dq, "  __syncthreads();  // q, dO and O landed everywhere\n",
                 "  STAMP(2);\n")
    dq = _insert(dq, "  for (int t = 0; t < n_tiles; ++t) {",
                 "  STAMP(3);\n", after=False)
    dq = _insert(dq, "    __syncthreads();  // tile t landed everywhere\n",
                 "    if (t == 0) STAMP(4);\n")
    dq = _insert(dq, "  }\n  repro::cp_async_wait<0>();\n", "  STAMP(5);\n")
    i = dq.rindex("}\n")
    dq = dq[:i] + "  STAMP(6);\n" + dq[i:]
    dkv = _insert(dkv, "  const int tid = threadIdx.x;",
                  f"  constexpr int kStampBase = {BWD_DKV_ROW};\n"
                  "  STAMP(0);\n", after=False)
    dkv = _insert(dkv, "  if (t_lo < t_hi) issue(t_lo);\n"
                  "  repro::cp_async_commit();\n", "  STAMP(1);\n")
    dkv = _insert(dkv, "    __syncthreads();  // tile t (and, first, k and v) "
                  "landed everywhere\n", "    if (t == t_lo) STAMP(2);\n")
    dkv = _insert(dkv, "    __syncthreads();  // tile t's slot free for tile "
                  "t + 2\n", "    if (t == t_lo) STAMP(3);\n", after=False)
    dkv = _insert(dkv, "  {\n    // row groups 1, 2,", "  STAMP(4);\n",
                  after=False)
    dkv = _insert(dkv, "  // write the block's keys", "  STAMP(5);\n",
                  after=False)
    i = dkv.rindex("}\n")
    dkv = dkv[:i] + "  STAMP(6);\n" + dkv[i:]
    return (head + "flash_bwd_dq_mma_kernel(" + dq
            + "flash_bwd_dkv_mma_kernel(" + dkv + "struct Args {" + tail)


def decode_header(csrc: Path) -> str:
    h = (csrc / "decode_body.cuh").read_text()
    h = _insert(h, '#include "mma.cuh"\n', STAMPS)
    h = _insert(h, "  const int cap = rows.capacity();\n", "  STAMP(0);\n")
    h = _insert(h, "      __syncthreads();  // s_row of round tn\n",
                "      if (tn == 0) STAMP(1);\n")
    h = _insert(h, "        __syncthreads();  // ... landed for every thread\n",
                "        if (t == 0 && tt == 0) STAMP(2);\n")
    h = _insert(h, "  const long long slot = b * s.KV + g;\n", "  STAMP(3);\n",
                after=False)
    h = _insert(h, "      }\n    }\n    return;\n  }\n",
                "    __syncthreads();\n    STAMP(6);\n", after=False)
    h = _insert(h, "  if (!s_last) return;\n", "  STAMP(4);\n", after=False)
    h = _insert(h, "= M + logf(Lsum);\n    }\n",
                "    __syncthreads();\n    STAMP(6);\n")
    i = h.index("template <typename Rows>\nstruct Args")
    j = h.rindex("}\n", 0, i)
    return h[:j] + "  __syncthreads();\n  STAMP(6);\n" + h[j:]


def ssd_source(csrc: Path) -> str:
    s = (csrc / "ssd_scan.cu").read_text()
    s = _insert(s, '#include "mma.cuh"\n', STAMPS)
    head, body = s.split("__launch_bounds__(kThreads) ssd_mma_kernel(", 1)
    body, tail = body.split("}  // namespace tc", 1)
    body = _insert(body, "  const float a_h = A[h];\n", "  STAMP(0);\n",
                   after=False)
    body = _insert(body, "    __syncthreads();  // this chunk's rows and the "
                   "state copy landed\n", "    if (ci == 0) STAMP(1);\n")
    body = _insert(body, "\n    if (row_warp) {\n",
                   "\n    if (ci == 0) STAMP(2);", after=False)
    body = _insert(body, "      // ---- decay and mask the scores",
                   "      if (ci == 0) STAMP(3);\n", after=False)
    body = _insert(body, "    __syncthreads();  // every warp is done with "
                   "this stage and the state copy\n",
                   "    if (ci == 0) STAMP(4);\n", after=False)
    body = _insert(body, "    __syncthreads();  // every warp is done with "
                   "this stage and the state copy\n",
                   "    if (ci == 0) STAMP(5);\n")
    i = body.rindex("}\n")
    body = body[:i] + "  STAMP(6);\n" + body[i:]
    return (head + "__launch_bounds__(kThreads) ssd_mma_kernel(" + body
            + "}  // namespace tc" + tail)


def w8a8_source(csrc: Path) -> str:
    s = (csrc / "matmul_w8a8.cu").read_text()
    s = _insert(s, '#include "mma.cuh"\n', STAMPS)
    s = _insert(s, "  const int n_kt = (K + kBK - 1) / kBK;\n",
                "  STAMP(0);\n")
    s = _insert(s, "    __syncthreads();  // tile kt landed; every warp is "
                "done with tile kt - 1\n", "    if (kt == 0) STAMP(1);\n")
    s = _insert(s, "    // the next iteration's first barrier",
                "    if (kt == 0) STAMP(3);\n", after=False)
    s = _insert(s, "  // ---- epilogue:", "  STAMP(4);\n", after=False)
    i = s.index("template <int WM, int WN>\nint launch(")
    j = s.rindex("}\n", 0, i)
    return s[:j] + "  STAMP(6);\n" + s[j:]


def page_source(csrc: Path) -> str:
    s = (csrc / "page_io.cu").read_text()
    s = _insert(s, '#include "common.cuh"\n', STAMPS)
    s = _insert(s, "  const Seg& s = g.seg[blockIdx.y];\n  unsigned tile",
                "  STAMP(0);\n", after=False)
    s = _insert(s, "  if (tile >= s.n_tiles) return;\n", "  STAMP(4);\n")
    s = _insert(s, "  bool pre = s.src_ids == nullptr;\n",
                "  if (s.vec > 0) STAMP(5);\n")
    s = _insert(s, "  if (s.stage) stage_ids(s, s_ids);\n", "  STAMP(1);\n",
                after=False)
    s = _insert(s, "  if (s.stage) stage_ids(s, s_ids);\n  __syncthreads();\n",
                "  STAMP(2);\n  bool pre_first = true;\n")
    s = _insert(s, "    store_any(s, s_ids, buf, w);\n",
                "    if (pre_first) STAMP(3);\n    pre_first = false;\n")
    return _insert(s, "    pre_first = false;\n  }\n", "  STAMP(6);\n")


def build_copies(build):
    """Build the instrumented libraries and load them in place of the
    repository's (`build._LIBS`)."""
    OUT.mkdir(parents=True, exist_ok=True)
    for f in ("common.cuh", "mma.cuh"):
        (OUT / f).write_text((build.CSRC / f).read_text())
    (OUT / "decode_body.cuh").write_text(decode_header(build.CSRC))
    sources = {"flash_attention": flash_source(build.CSRC),
               "flash_attention_bwd": bwd_source(build.CSRC),
               "paged_decode": (build.CSRC / "paged_decode.cu").read_text(),
               "decode_attention":
                   (build.CSRC / "decode_attention.cu").read_text(),
               "ssd_scan": ssd_source(build.CSRC),
               "matmul_w8a8": w8a8_source(build.CSRC),
               "page_io": page_source(build.CSRC)}
    procs = {}
    for name, text in sources.items():
        src = OUT / f"{name}.cu"
        src.write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o",
               str(OUT / f"lib{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the copy of {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        build._LIBS[name] = lib
        libs.append(lib)
    return libs


def report(kind, label, table, n_blocks, row0=0):
    ns = table[row0:row0 + n_blocks]
    cyc = table[CYCLES + row0:CYCLES + row0 + n_blocks]
    # blocks that found no work (a page copy's short segments) stamp
    # nothing after their start
    live = [i for i in range(n_blocks) if ns[i][0] > 0 and ns[i][6] > 0]
    t0 = min(int(ns[i][0]) for i in live)
    span = max(int(ns[i][6]) for i in live) - t0
    print(f"{kind} {label}: {len(live)} of {n_blocks} blocks ran, kernel "
          f"span {span / 1e3:.2f} us on {len({int(ns[i][7]) for i in live})}"
          " SMs")
    for a, b, what in PHASES[kind]:
        pairs = [(int(ns[i][b]) - int(ns[i][a]),
                  int(cyc[i][b]) - int(cyc[i][a]))
                 for i in live if ns[i][a] > 0 and ns[i][b] > 0]
        if pairs:
            us = [p[0] / 1e3 for p in pairs]
            print(f"   {what:38s} median {statistics.median(us):6.2f} us "
                  f"max {max(us):6.2f} us; median "
                  f"{statistics.median(p[1] for p in pairs):6.0f} cycles "
                  f"(n={len(pairs)})")
    ghz = [(int(cyc[i][6]) - int(cyc[i][0])) / (int(ns[i][6]) - int(ns[i][0]))
           for i in live if ns[i][6] > ns[i][0]]
    print(f"   SM clock from the two counters: median "
          f"{statistics.median(ghz):.3f} GHz")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated kernels: " + ", ".join(PHASES))
    only = set(ap.parse_args(argv).only.split(","))
    import torch

    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import decode_attention as da
    from repro_torch.kernels.decode_attention import paged as dpaged
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.matmul_w8a8 import matmul_w8a8 as mm
    from repro_torch.kernels.ssd_scan import ssd_scan as sks

    smi = chip_smoke.smi_line()
    print(f"device: {smi}")
    timer = chip_smoke.Timer(torch)
    gen = torch.Generator("cuda").manual_seed(0)
    stamps = torch.zeros(2 * CYCLES * 8, dtype=torch.int64, device="cuda")
    for lib in build_copies(build):
        if lib.phases_set(ctypes.c_void_p(stamps.data_ptr())):
            raise RuntimeError("kernel_phases: cudaMemcpyToSymbol failed")

    def clocks():
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()

    def run(kind, label, fn, n_blocks, row0=0):
        if kind not in only:
            return
        for _ in range(200):
            timer._flush()
            fn()
        torch.cuda.synchronize()
        print(f"{kind} {label}: nvidia-smi clocks.sm, clocks.max.sm after "
              f"200 calls: {clocks()}")
        for cold in (True, False):
            stamps.zero_()
            if cold:
                timer._flush()
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            report(kind, f"{label}, {'L2 flushed' if cold else 'warm'}",
                   stamps.view(-1, 8).cpu().tolist(), n_blocks, row0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    H, KV, D = 15, 5, 64
    q, k = randn(1, 128, H, D), randn(1, 128, KV, D)
    v = randn(1, 128, KV, D, scale=0.5)
    for rows in (None, 64):
        plan = fa._mma_plan(1, 128, 128, H, KV, D, rows=rows)
        run("flash", f"rows={plan.rows} key_groups={plan.key_groups} "
            f"n_split={plan.n_split}",
            lambda plan=plan: fa.flash_mha_cuda(q, k, v, plan=plan),
            plan.grid[0] * plan.grid[1] * plan.grid[2])
    # paligemma-3b's prefix + prompt: B 1, S 384, 8 heads on 1, D 256
    qp, kp2 = randn(1, 384, 8, 256), randn(1, 384, 1, 256)
    vp2 = randn(1, 384, 1, 256, scale=0.5)
    plan = fa.launch_plan(1, 384, 384, 8, 1, 256, torch.bfloat16)
    run("flash", f"paligemma S=384 8/1 D=256 rows={plan.rows} "
        f"key_groups={plan.key_groups} n_split={plan.n_split}",
        lambda: fa.flash_mha_cuda(qp, kp2, vp2, plan=plan),
        plan.grid[0] * plan.grid[1] * plan.grid[2])

    from repro_torch.kernels.flash_attention import chunked

    Bt, St = 8, 256
    qt, kt = randn(Bt, St, H, D), randn(Bt, St, KV, D)
    vt, dot = randn(Bt, St, KV, D, scale=0.5), randn(Bt, St, H, D)
    ot, lse4 = chunked._fwd(qt, kt, vt, True, None, 0, 512, 512)
    lset = lse4.reshape(Bt, H, St).contiguous()
    bplan = fa.bwd_plan(Bt, St, St, H, KV, D, torch.bfloat16)
    label = f"B={Bt} S={St} rows={bplan.rows} keys={bplan.keys}"

    def call():
        return fa.flash_mha_bwd_cuda(qt, kt, vt, ot, lset, dot)

    run("bwd_dq", label, call, bplan.dq_grid[0] * bplan.dq_grid[1])
    run("bwd_dkv", label, call, bplan.dkv_grid[0] * bplan.dkv_grid[1],
        BWD_DKV_ROW)

    B, page, n_pages = 8, 16, 16
    P = B * n_pages
    qd = randn(B, H, D)
    bt = torch.stack([torch.randperm(P, generator=gen, device="cuda")
                      [:n_pages] for _ in range(B)]).to(torch.int32)
    kp = torch.randint(-127, 128, (P, page, KV, D), generator=gen,
                       device="cuda", dtype=torch.int8)
    vp = torch.randint(-127, 128, (P, page, KV, D), generator=gen,
                       device="cuda", dtype=torch.int8)

    def sz():
        s = torch.rand((P, KV), generator=gen, device="cuda")
        z = torch.rand((P, KV), generator=gen, device="cuda") - 0.5
        return torch.stack([0.005 + 0.015 * s, z], -1)

    ksz, vsz = sz(), sz()
    lens = torch.tensor([70, 100, 129, 160, 200, 240, 256, 257],
                        dtype=torch.int32, device="cuda")
    for span in (dpaged.SPAN, 256):
        plan = dpaged.decode_plan(B, H, KV, D, n_pages * page, torch.int8,
                                  span)
        run("decode", f"paged int8/page span={span}",
            lambda span=span: dpaged.paged_flash_decode_cuda(
                qd, kp, vp, bt, lens, k_sz=ksz, v_sz=vsz, span=span),
            KV * B * plan.n_span)
    S = 256
    kc, vc = randn(B, S, KV, D), randn(B, S, KV, D, scale=0.5)
    lc = torch.tensor([129, 133, 137, 141, 145, 150, 155, 160],
                      dtype=torch.int32, device="cuda")
    run("decode", f"contiguous bf16 span={dpaged.SPAN}",
        lambda: da.flash_decode_cuda(qd, kc, vc, lc),
        KV * B * dpaged.decode_plan(B, H, KV, D, S, torch.bfloat16).n_span)
    # paligemma-3b's int8/page pool: B 8, 8 heads on 1, D 256, 26 pages
    Hg, KVg, Dg, n_pg = 8, 1, 256, 26
    Pg = B * n_pg
    qg = randn(B, Hg, Dg)
    btg = torch.stack([torch.randperm(Pg, generator=gen, device="cuda")
                       [:n_pg] for _ in range(B)]).to(torch.int32)
    kpg, vpg = (torch.randint(-127, 128, (Pg, page, KVg, Dg), generator=gen,
                              device="cuda", dtype=torch.int8)
                for _ in range(2))
    szg = [torch.stack([0.005 + 0.015 * torch.rand((Pg, KVg), generator=gen,
                                                   device="cuda"),
                        torch.rand((Pg, KVg), generator=gen, device="cuda")
                        - 0.5], -1) for _ in range(2)]
    lg = torch.tensor([320, 330, 340, 350, 360, 370, 380, 400],
                      dtype=torch.int32, device="cuda")
    plan = dpaged.decode_plan(B, Hg, KVg, Dg, n_pg * page, torch.int8)
    run("decode", f"paligemma int8/page B=8 8/1 D=256 span={plan.span}",
        lambda: dpaged.paged_flash_decode_cuda(qg, kpg, vpg, btg, lg,
                                               k_sz=szg[0], v_sz=szg[1]),
        KVg * B * plan.n_span)
    # the lse variant's long shapes (chip_smoke.LSE_SHAPES): qwen2.5-32b's
    # 16x16 rank and a 16384-position block
    for label, Bl, Hl, KVl, Dl, Sl, lengths in chip_smoke.LSE_SHAPES[1:]:
        ql = randn(Bl, Hl, Dl)
        kl, vl = randn(Bl, Sl, KVl, Dl), randn(Bl, Sl, KVl, Dl, scale=0.5)
        ll = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        plan = dpaged.decode_plan(Bl, Hl, KVl, Dl, Sl, torch.bfloat16)
        run("decode", f"contiguous bf16 lse {label} B={Bl} {Hl}/{KVl} "
            f"D={Dl} S={Sl} span={plan.span} n_span={plan.n_span}",
            lambda ql=ql, kl=kl, vl=vl, ll=ll: da.flash_decode_cuda(
                ql, kl, vl, ll, return_lse=True),
            KVl * Bl * plan.n_span)

    F = torch.nn.functional
    Hs, Ps, Ns = 48, 64, 128
    ssd_args = (randn(1, 128, Hs, Ps), F.softplus(randn(1, 128, Hs).float()),
                -torch.exp(randn(Hs).float() * 0.5), randn(1, 128, 1, Ns),
                randn(1, 128, 1, Ns), randn(Hs).float())
    plan = sks.launch_plan(1, Hs, Ps, Ns, torch.bfloat16)
    run("ssd", f"bf16 B=1 S=128 pb={plan.pb} stages={plan.stages}",
        lambda: sks.ssd_cuda(*ssd_args),
        plan.grid[0] * plan.grid[1] * plan.grid[2])
    a8 = torch.randint(-127, 128, (1024, 960), generator=gen, device="cuda",
                       dtype=torch.int8)
    b8 = torch.randint(-127, 128, (960, 2560), generator=gen, device="cuda",
                       dtype=torch.int8)
    sa = torch.rand(1024, generator=gen, device="cuda")
    sb = torch.rand(2560, generator=gen, device="cuda")
    wplan = mm.launch_plan(1024, 2560)
    run("w8a8", f"M=1024 K=960 N=2560 tile=({wplan.bm}, {wplan.bn})",
        lambda: mm.matmul_w8a8_cuda(a8, b8, sa, sb),
        wplan.grid[0] * wplan.grid[1])
    from repro_torch.kernels.page_io import page_io as pio

    nb, Pp, page = 32, 128, 16
    spec = (((page, KV, D), torch.int8), ((KV, 2), torch.float32)) * 2
    pools = [torch.zeros((nb, Pp, *sh), dtype=dt, device="cuda")
             for sh, dt in spec]
    tiles = [torch.ones((nb, 8, *sh), dtype=dt, device="cuda")
             for sh, dt in spec]
    phys = torch.randperm(Pp, generator=gen, device="cuda")[:8].to(
        torch.int32)
    for label, idx in (("grouped k,k_sz,v,v_sz", [0, 1, 2, 3]),
                       ("k payload alone", [0]), ("k_sz rows alone", [1])):
        pl, tl = [pools[i] for i in idx], [tiles[i] for i in idx]
        plan = pio.plan(pio.write_segments(pl, tl, phys))
        run("page", f"{label}: {plan.n_tiles} tiles on grid {plan.grid}",
            lambda pl=pl, tl=tl: pio.write_pages_cuda(pl, tl, phys),
            plan.grid[0] * plan.grid[1])
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
