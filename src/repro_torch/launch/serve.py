"""Serving driver: thin CLI over the continuous-batching engine (the port
of ``repro/launch/serve.py``).

Builds a synthetic mixed-length request trace and drives
``repro_torch.serve.InferenceEngine`` (paged KV cache, prefill/decode
interleave, per-request sampling; dense and MoE attention archs).
Architectures the paged engine refuses -- recurrent mixers (RWKV-6,
RG-LRU), cross attention, the embedding frontend, the int8 KV cache --
run the static loop ``legacy_generate``, as in the reference.

  # Qwen3-1.7B at full width on the card (random weights from a seed)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --requests 16 --slots 8 --prompt-len 128 --prompt-len-max 1024 \\
      --gen 32 --num-pages 1024 --max-seq-len 2048

  # a reduced config on the CPU (plain versions of the kernels); the same
  # for recurrentgemma-9b, llama-3.2-vision-90b, musicgen-large (static
  # loop) and mixtral-8x7b, moonshot-v1-16b-a3b (engine)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
      --reduced --requests 2 --prompt-len 8 --gen 4 --device cpu

  # telemetry: engine_step > admission / prefill / decode_step spans and
  # reject / preempt / finish instants, the serving health rules, a live
  # endpoint and a postmortem bundle on exit
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --reduced --requests 4 --slots 2 --prompt-len 8 --gen 8 \\
      --page-size 8 --max-seq-len 64 --device cpu --trace /tmp/serve.json \\
      --health --listen 127.0.0.1:0 --flight-recorder /tmp/serve.bundle.json
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..configs import get_config
from ..core.util import resolve_device
from ..models import Transformer, reduced
from ..obs import serve_rules
from ..serve import EngineConfig, InferenceEngine, Request, SamplingParams
from .obs import add_trace_metrics_flags, open_plane


def build_trace(cfg, n_requests, plen_min, plen_max, gen_min, gen_max,
                sampling: SamplingParams, seed=0):
    """Synthetic mixed-length trace: random prompts, per-request seeds."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_requests):
        plen = int(rng.integers(plen_min, plen_max + 1))
        gen = int(rng.integers(gen_min, gen_max + 1))
        prompt = rng.integers(0, cfg.vocab, size=plen)
        sp = SamplingParams(temperature=sampling.temperature,
                            top_k=sampling.top_k, top_p=sampling.top_p,
                            seed=sampling.seed + i)
        reqs.append(Request(rid=i, prompt=prompt,
                            max_new_tokens=gen, sampling=sp))
    return reqs


def static_batch_generate(model, params, requests, batch_size):
    """The static loop: fixed batches, right-padded prefill, every slot
    decodes until the slowest request in its batch finishes.  Returns
    {rid: generated tokens}.

    As in the reference: in a batch of MIXED prompt lengths the shorter
    rows are right-padded and their first token argmaxed at the padded
    position, so token-for-token equality with the engine holds only for
    uniform-length batches."""
    params = model.compute_params(params)
    outputs = {}
    for lo in range(0, len(requests), batch_size):
        batch = requests[lo: lo + batch_size]
        B = len(batch)
        S = max(len(r.prompt) for r in batch)
        gen = max(r.max_new_tokens for r in batch)
        toks = np.zeros((B, S), np.int32)
        for b, r in enumerate(batch):
            toks[b, : len(r.prompt)] = r.prompt
        logits, cache = model.prefill(
            params, {"tokens": torch.as_tensor(toks, device=model.device)},
            S + gen)
        rows = []
        for _ in range(gen):
            nxt = torch.argmax(logits[:, -1], dim=-1)
            rows.append(nxt.cpu().numpy())
            logits, cache = model.decode_step(params, cache,
                                              {"tokens": nxt[:, None]})
        out = np.stack(rows, axis=1).astype(np.int32)
        for b, r in enumerate(batch):
            outputs[r.rid] = out[b, : r.max_new_tokens]
    return outputs


def legacy_generate(cfg, model, params, args):
    """The static loop for archs the paged engine can't serve (recurrent
    mixers, XATTN encoders, embedding frontends, the int8 cache): one
    fixed batch of ``args.requests`` random inputs of ``args.prompt_len``
    positions, contiguous ring-buffer cache, ``args.gen`` greedy steps.
    Inputs come from a ``torch.Generator`` seeded with 1, drawn on the
    host: token prompts, or frame embeddings (then fresh ones each decode
    step, as the reference feeds its stub frontend), and stub encoder
    states (B, encoder_len, d_model) where the pattern has XATTN layers.
    Returns {index: generated tokens} like the engine path."""
    params = model.compute_params(params)
    B, S = args.requests, args.prompt_len
    dev, cdt = model.device, cfg.cdtype
    gen = torch.Generator()
    gen.manual_seed(1)
    if cfg.embed_input == "tokens":
        batch = {"tokens": torch.randint(0, cfg.vocab, (B, S),
                                         generator=gen).to(dev)}
    else:
        batch = {"embeds": torch.randn((B, S, cfg.d_model),
                                       generator=gen).to(dev, cdt)}
    if cfg.encoder_len:
        batch["encoder"] = torch.randn((B, cfg.encoder_len, cfg.d_model),
                                       generator=gen).to(dev)
    with torch.no_grad():
        logits, cache = model.prefill(params, batch, S + args.gen)
        toks = []
        for _ in range(args.gen):
            nxt = torch.argmax(logits[:, -1], dim=-1)
            toks.append(nxt.cpu().numpy())
            if cfg.embed_input == "tokens":
                step_in = {"tokens": nxt[:, None]}
            else:
                step_in = {"embeds": torch.randn(
                    (B, 1, cfg.d_model), generator=gen).to(dev, cdt)}
            logits, cache = model.decode_step(params, cache, step_in)
    out = np.stack(toks, axis=1).astype(np.int32)
    return {i: out[i] for i in range(B)}


def build_parser():
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve",
        description="LM serving CLI (PyTorch/CUDA port)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="minimum prompt length of the trace")
    ap.add_argument("--prompt-len-max", type=int, default=None,
                    help="maximum prompt length (default: --prompt-len)")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--gen-min", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=256)
    ap.add_argument("--max-seq-len", type=int, default=512)
    return add_trace_metrics_flags(
        ap, trace_help="trace the serve loop and write Chrome-trace JSON "
                       "here (engine_step > admission / prefill / "
                       "decode_step spans, preempt/finish/reject "
                       "instants); open in chrome://tracing or "
                       "ui.perfetto.dev",
        metrics_help="print the metrics-registry snapshot (the same "
                     "schema solver telemetry uses) after the run")


def main(argv=None, *, on_summary=None):
    """Serve the synthetic trace; returns ``{rid: generated tokens}``.
    ``on_summary``, if given, is called with the engine's metrics summary
    (the JSON block printed; not called on the static loop)."""
    ap = build_parser()
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    device = resolve_device(args.device)
    model = Transformer(cfg, device=device)
    params = model.init(0)

    sampling = SamplingParams(temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p,
                              seed=args.seed)
    plen_max = args.prompt_len_max or args.prompt_len
    gen_min = args.gen_min or args.gen
    if plen_max < args.prompt_len:
        ap.error("--prompt-len-max must be >= --prompt-len")
    if gen_min > args.gen:
        ap.error("--gen-min must be <= --gen")
    if args.prompt_len + gen_min > args.max_seq_len:
        ap.error(f"--prompt-len + --gen-min exceeds --max-seq-len "
                 f"({args.max_seq_len}): every request would be rejected")
    reqs = build_trace(cfg, args.requests, args.prompt_len, plen_max,
                       gen_min, args.gen, sampling, seed=args.seed)

    tracer, registry, plane = open_plane(
        args, rules=serve_rules, meta={"cli": "serve", "arch": args.arch})
    try:
        engine = InferenceEngine(model, params, EngineConfig(
            max_slots=args.slots, page_size=args.page_size,
            num_pages=args.num_pages, max_seq_len=args.max_seq_len),
            tracer=plane.tracer_or(tracer), registry=registry,
            monitor=plane.monitor)
    except NotImplementedError as e:
        plane.finalize()
        print(f"note: {e}")
        print("falling back to the static loop (greedy, fixed batch)")
        outputs = legacy_generate(cfg, model, params, args)
        print("generated token ids (first request):",
              outputs[min(outputs)][:16])
        return outputs
    with plane.crash_guard():
        outputs = engine.run(reqs)

    s = engine.metrics.summary()
    if on_summary is not None:
        on_summary(s)
    print(f"{len(outputs)} requests, {s['generated_tokens']} tokens in "
          f"{s['elapsed_s']:.2f}s ({s['tokens_per_sec']:.1f} tok/s); "
          f"ttft p50 {s['ttft_s']['p50'] * 1e3:.0f} ms, "
          f"latency p99 {s['latency_s']['p99'] * 1e3:.0f} ms")
    print(json.dumps(s, indent=1))
    if registry is not None:
        print(json.dumps(registry.snapshot(), indent=1))
    if plane.active:
        print(json.dumps({"obs": plane.finalize()}, indent=1))
    if tracer is not None:
        tracer.write_chrome_trace(args.trace)
        print(f"trace: {len(tracer.events)} events -> {args.trace}")
    if s["rejections"]:
        print(f"{s['rejections']} request(s) rejected "
              f"(prompt + gen > --max-seq-len, or queue full)")
    if outputs:
        print("generated token ids (first request):",
              outputs[min(outputs)][:16])
    return outputs


if __name__ == "__main__":
    main()
