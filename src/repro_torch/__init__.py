"""PyTorch/CUDA port of the `repro` package for one NVIDIA H100.

The layout mirrors `src/repro/` file for file, so each module here has
one obvious counterpart there. The port imports `torch` and numpy, never
`jax` and never `repro`: host-side modules that `repro` keeps in numpy
are copied in, not imported. Every Pallas kernel on the ported path has a
hand-written CUDA C++ kernel for `sm_90a` under `kernels/csrc/`, built
with `nvcc` at first use; each sits beside a plain PyTorch version that
CPU tensors take (see `repro_torch.kernels`).

Entry points (`models.model.init_model`, `runtime.serve.
make_engine_cells`, `serving.engine.ServingEngine.build`) run on the card
unless the caller passes `device="cpu"`; without a card they raise
instead of moving to the CPU.
"""
