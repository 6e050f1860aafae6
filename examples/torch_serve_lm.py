"""Serving example on the PyTorch/CUDA port: a mixed-length request trace
through the continuous-batching engine (paged KV cache, per-request
sampling seeds), reporting tokens/s, TTFT and latency percentiles -- the
counterpart of ``examples/serve_lm.py``.

    PYTHONPATH=src python examples/torch_serve_lm.py [--arch mixtral-8x7b]
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

It drives the serving CLI's ``main`` (``repro_torch.launch.serve``) on
the reduced config of ``--arch`` with random weights from seed 0: 6
requests over 3 slots, prompts of 8 to 24 tokens, ``--gen`` tokens each,
pages of 8 tokens, sequences of at most 64; greedy decoding.  Every
prefill runs the flash attention kernel in each attention layer.
``--device`` defaults to ``cuda`` and raises on a machine without a card.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.launch import serve as serve_mod  # noqa: E402


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--gen", type=int, default=12)
    return ap


def argv_of(args):
    """The serving CLI's arguments the example runs."""
    return ["--arch", args.arch, "--reduced", "--requests", "6",
            "--slots", "3", "--prompt-len", "8", "--prompt-len-max", "24",
            "--gen", str(args.gen), "--page-size", "8", "--max-seq-len",
            "64", "--device", args.device]


def main(argv=None):
    """Run the example; returns the CLI's ``outputs`` ({request id:
    generated tokens}) and the engine's metrics ``summary`` (tokens/s,
    TTFT and latency percentiles, prefills; None on the static loop of
    an architecture the engine refuses)."""
    args = build_parser().parse_args(argv)
    got = {}
    outputs = serve_mod.main(argv_of(args), on_summary=got.update)
    return {"outputs": outputs, "summary": got or None}


if __name__ == "__main__":
    main()
