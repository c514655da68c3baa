"""Serving example of the PyTorch port: the continuous-batching engine on
the reduced paligemma VLM (frontend-stub path, one-shot burst) and on
smollm under the bursty arrival scenario with tier-aware KV paging (the
twin of `examples/serve_batch.py`).

    PYTHONPATH=src python examples/serve_batch_torch.py
    PYTHONPATH=src python examples/serve_batch_torch.py --device cpu

Runs on the card unless `--device` names another.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.launch import serve  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = ["--device", ap.parse_args(argv).device]
    serve.main([
        "--arch", "paligemma-3b", "--reduced",
        "--batch", "4", "--prompt-len", "24", "--gen", "12", *dev,
    ])
    serve.main([
        "--arch", "smollm-360m", "--reduced",
        "--scenario", "bursty", "--requests", "12", "--slots", "4", *dev,
    ])


if __name__ == "__main__":
    main()
