"""Where the port's prompt pass gives other bits for a prompt alone than
for the same prompt inside a batch of 8, and what that does to the fp
engine's agreement with the naive loop.

    PYTHONPATH=src python scripts/prefill_batch_bits.py [arch ...]

Three readings, on the card (published widths, seeded random weights)
or, without one, on the CPU (reduced configs):

1. GEMM: `torch.einsum("bsd,df->bsf")` over 128 rows against the first
   128 rows of the same product over 1024, bf16 and float32, at the
   archs' projection shapes, with and without bf16 reduced-precision
   reductions.
2. Prompt pass: every einsum, `@` and flash_mha call of `prefill` for
   request 0 alone against its rows in the batch of 8, in call order;
   the first calls that differ, and per kind how many differ.
3. Engine: the paged fp engine's tokens (8 prompts of 128, 32 new)
   against the naive loop with a batched prefill and with each prompt
   prefilled alone (`dev_serve_torch.naive_greedy(each=...)`).
"""

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import dev_serve_torch as dst  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.module import cast_params  # noqa: E402
from repro_torch.serving import make_scenario  # noqa: E402

DEV = "cuda" if torch.cuda.is_available() else "cpu"
ARCHS = ("granite_moe_1b_a400m", "seamless_m4t_large_v2", "paligemma_3b")
GEMM_KN = ((1024, 1024), (1024, 512), (1024, 8192), (8192, 1024),
           (2048, 16384), (16384, 2048), (2048, 2048), (1024, 49155))
_calls = None       # the prompt pass's recorded outputs, when recording


def _recorded(name, fn):
    def call(*a, **k):
        out = fn(*a, **k)
        if _calls is not None:
            label = name + (" " + a[0] if isinstance(a[0], str) else "")
            shapes = [tuple(x.shape) for x in a if torch.is_tensor(x)]
            o = out[0] if isinstance(out, tuple) else out
            _calls.append((label, shapes, o.detach().clone()))
        return out
    return call


def _rows_of_first(o8, o1):
    """o8's part that holds request 0 (the dim 8x as long as o1's)."""
    if o8.shape == o1.shape:
        return o8
    for d in range(o8.ndim):
        if (o8.shape[d] == 8 * o1.shape[d] and o8.shape[:d] == o1.shape[:d]
                and o8.shape[d + 1:] == o1.shape[d + 1:]):
            return o8.narrow(d, 0, o1.shape[d])
    return None


def gemms():
    for reduced in (True, False):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            reduced)
        for dt in (torch.bfloat16, torch.float32):
            for K, N in GEMM_KN:
                g = torch.Generator(DEV).manual_seed(1)
                x = torch.randn(8, 128, K, generator=g, device=DEV).to(dt)
                w = torch.randn(K, N, generator=g, device=DEV).to(dt)
                one = torch.einsum("bsd,df->bsf", x[:1], w)
                eight = torch.einsum("bsd,df->bsf", x, w)[:1]
                print(f"GEMM reduced_bf16={reduced} {dt} M 128 vs 1024 K {K} "
                      f"N {N}: bit-equal {bool(torch.equal(one, eight))}")


def prompt_pass(arch, cfg0, params, prompts):
    global _calls
    batch = {"tokens": torch.as_tensor(prompts, device=DEV),
             **dst.frontend_batch(cfg0, 8, prompts.shape[1], DEV)}
    for dt in ("bfloat16", "float32"):
        cfg = dataclasses.replace(cfg0, dtype=dt)
        p = cast_params(params, dt)
        b = {k: v.to(getattr(torch, dt)) if v.is_floating_point() else v
             for k, v in batch.items()}
        _calls = []
        _, l1 = M.prefill(p, {k: v[:1] for k, v in b.items()}, cfg,
                          max_seq=256)
        c1, _calls = _calls, []
        _, l8 = M.prefill(p, b, cfg, max_seq=256)
        c8, _calls = _calls, None
        print(f"{arch} {dt}: calls {len(c1)}/{len(c8)}; logits of request 0 "
              f"bit-equal {bool(torch.equal(l8[:1], l1))} max diff "
              f"{float((l8[:1].float() - l1.float()).abs().max()):.3e}; "
              f"argmax equal "
              f"{bool(torch.equal(l8[:1].argmax(-1), l1.argmax(-1)))}")
        kinds, first = {}, []
        for (name, s1, o1), (_, s8, o8) in zip(c1, c8):
            part = _rows_of_first(o8, o1)
            same = part is not None and torch.equal(part, o1)
            key = (name, str(s1[1:]))
            kinds.setdefault(key, [0, 0])[same] += 1
            if not same and len(first) < 6:
                first.append((name, s1, s8, None if part is None else float(
                    (part.float() - o1.float()).abs().max())))
        for f in first:
            print("   first differing:", f)
        for key, (differ, equal) in kinds.items():
            print(f"   {key}: differ {differ} equal {equal}")


def engines(arch, cfg0, params, prompts):
    for dt in ("bfloat16", "float32"):
        cfg = dataclasses.replace(cfg0, dtype=dt)
        toks, _, _ = dst.engine_greedy(
            cfg, params, prompts, 32, max_seq=256, page_tokens=16,
            device=DEV, paged=True, pool_dtype="fp")
        got = {each: dst.compare(toks, dst.naive_greedy(
            cfg, params, prompts, 32, max_seq=256, device=DEV, each=each))
            for each in (False, True)}
        print(f"ENGINE {arch} {dt}: vs batched naive {got[False]}; vs "
              f"per-prompt naive {got[True]}")


def main(archs) -> int:
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {DEV}")
    torch.einsum = _recorded("einsum", torch.einsum)
    torch.Tensor.__matmul__ = _recorded("matmul", torch.Tensor.__matmul__)
    flash_ops.mha = _recorded("flash_mha", flash_ops.mha)
    gemms()
    for arch in archs:
        cfg0 = (configs.get if DEV == "cuda" else configs.reduced)(arch)
        params = M.init_model(cfg0, torch.Generator(DEV).manual_seed(0))
        reqs = make_scenario("chat", 8, cfg0.vocab_size, seed=0,
                             prompt_buckets=(128,), gen_range=(32, 32))
        prompts = np.stack([r.tokens for r in reqs])
        prompt_pass(arch, cfg0, params, prompts)
        engines(arch, cfg0, params, prompts)
        del params
        if DEV == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ARCHS))
