"""The statically-schedulable end of the prefetch spectrum (port of
`repro.prefetch.static`, the `static` corner of the predictor zoo).

`scan_with_prefetch` runs a loop over stacked layer params where the
pool-resident leaves (pinned host tensors) are streamed host->device one
layer AHEAD of use, into one of two device buffers: the page-copy kernel
(`kernels.page_io`, counted as the `layer_in` stream) copies layer i+1 on
a side stream while layer i computes on the main one, as the reference's
double buffer in the scan carry lets XLA overlap its copy-start/copy-done
pairs with the previous layer. Accuracy is structurally 100% (the layer
schedule is static); coverage is min(1, t_layer_compute /
t_layer_transfer).

`layer_stream_trace` emits the same schedule as an `AccessTrace`, so the
`StaticSchedulePredictor` scores 1.0 accuracy/coverage through the SAME
`PrefetchEngine` that scores the dynamic predictors.

When the carry is not on a card, the transfer is the identity and the
loop is a plain loop over the layers, as the reference's on XLA:CPU. On a
card the copy always goes through the kernel, which raises on a host leaf
it cannot reach (one that is not pinned).
"""

from __future__ import annotations

from typing import Callable

from repro_torch.common.pytree import tree_leaves, tree_map
from repro_torch.prefetch.trace import AccessTrace


def _stack(outs: list):
    """The per-layer outputs stacked on a leading layer axis (None when
    the body returns None), as `lax.scan` stacks them."""
    import torch

    def stack(*xs):
        if xs[0] is None:
            return None
        return torch.stack([torch.as_tensor(x) for x in xs])

    return tree_map(stack, *outs) if outs else None


def scan_with_prefetch(
    body: Callable,
    carry,
    stacked_params,
    pool_mask,
    n_layers: int,
):
    """Loop over layers with layer-ahead prefetch of pooled leaves.

    body(carry, layer_params) -> (carry, out); returns (carry, outs), outs
    stacked over the layers. Trees are nested dicts. pool_mask: tree of
    bools matching stacked_params — True leaves are pool-resident (pinned
    host tensors of shape (n_layers, ...); a host tensor that is not
    pinned raises) and get the double-buffer treatment. The last layer
    fetches nothing ahead (the reference re-fetches layer n_layers - 1,
    which it never reads).
    """
    import torch

    dev = next((x.device for x in tree_leaves(carry)
                if isinstance(x, torch.Tensor)), None)
    if dev is None or dev.type != "cuda":
        outs = []
        for i in range(n_layers):
            carry, out = body(carry, tree_map(lambda p: p[i], stacked_params))
            outs.append(out)
        return carry, _stack(outs)
    return _scan_cuda(body, carry, stacked_params, pool_mask, n_layers, dev)


def _scan_cuda(body, carry, stacked_params, pool_mask, n_layers, dev):
    import torch

    from repro_torch.kernels.page_io import ops as pops

    pooled: list = []
    tree_map(lambda p, m: pooled.append(p) if m else None, stacked_params,
             pool_mask)
    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    bufs = [[torch.empty(p.shape[1:], dtype=p.dtype, device=dev)
             for p in pooled] for _ in range(2)]
    ids = torch.arange(n_layers, dtype=torch.int32, device=dev)
    ready = [torch.cuda.Event(), torch.cuda.Event()]
    freed: list = [None, None]     # after the last body that read a buffer
    src = [p[None] for p in pooled]
    side.wait_stream(main)         # ids, buffers and the leaves are ready

    def fetch(i: int, b: int) -> None:
        with torch.cuda.stream(side):
            if freed[b] is not None:
                side.wait_event(freed[b])
            pops.copy_pages([x[None, None] for x in bufs[b]], None, src,
                            ids[i:i + 1], name="layer_in")
            ready[b].record(side)

    def layer(i: int, b: int):
        it = iter(bufs[b])
        return tree_map(lambda p, m: next(it) if m else p[i], stacked_params,
                        pool_mask)

    fetch(0, 0)
    outs = []
    for i in range(n_layers):
        b = i % 2
        if i + 1 < n_layers:
            # the next layer's copy goes ahead of this layer's compute
            fetch(i + 1, 1 - b)
        main.wait_event(ready[b])
        carry, out = body(carry, layer(i, b))
        outs.append(out)
        freed[b] = torch.cuda.Event()
        freed[b].record(main)
    main.wait_stream(side)
    return carry, _stack(outs)


def layer_stream_trace(n_layers: int = 24, pages_per_layer: int = 8,
                       epochs: int = 4,
                       page_bytes: float = 1 << 20) -> AccessTrace:
    """The layer loop's stream as an `AccessTrace`: step i touches all
    pages of layer (i mod n_layers). Fully schedulable — the `static`
    predictor's home turf."""
    steps = [
        [(i % n_layers) * pages_per_layer + p
         for p in range(pages_per_layer)]
        for i in range(n_layers * epochs)
    ]
    return AccessTrace(
        f"layer_stream_L{n_layers}", "layer", page_bytes,
        n_layers * pages_per_layer, steps,
    ).validate()
