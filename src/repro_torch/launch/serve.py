"""Batched LM serving driver, ported from ``repro.launch.serve``: prefill
a batch of prompts token by token into the decode caches, then decode.

  python -m repro_torch.launch.serve --arch qwen3-8b --reduced --batch 4 \\
      --prompt-len 32 --gen 16                       # on the card
  python -m repro_torch.launch.serve --arch qwen3-8b --reduced --device cpu

Weights and prompts come from seed 0 (``torch.Generator``s), as the
reference's come from ``PRNGKey(0)``. Greedy decoding is argmax; a
temperature above 0 samples from the softmax with its own generator.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs as cfglib
from repro_torch.core.device import resolve_device
from repro_torch.launch.train import reduced_100m
from repro_torch.models import lm


def prefill_into_cache(model, tokens, state, moe_impl: str = "capacity"):
    """Sequential prefill through decode_step (simple, and exactly the
    decode path; a fused prefill is a serving optimisation). Returns the
    last token's logits and the state."""
    logits = None
    for t in range(tokens.shape[1]):
        logits, state = lm.decode_step(model, tokens[:, t:t + 1], state,
                                       moe_impl=moe_impl)
    return logits, state


def _next(logits, vocab: int, temperature: float, gen):
    last = logits[:, -1, :vocab]
    if temperature > 0:
        probs = torch.softmax(last / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)
    return last.argmax(-1)[:, None]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=cfglib.ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    device = resolve_device(args.device, "repro_torch.launch.serve")
    cfg = cfglib.get_config(args.arch)
    if args.reduced:
        cfg = reduced_100m(cfg)
    model = lm.LM(cfg, device=device, seed=0)
    max_len = args.prompt_len + args.gen + 1
    state = lm.init_decode_state(cfg, args.batch, max_len, model.dtype,
                                 device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    logits, state = prefill_into_cache(model, prompts, state)
    sync()
    prefill_t = time.perf_counter() - t0

    out_tokens = []
    tok = _next(logits, cfg.vocab_size, args.temperature, gen)
    t0 = time.perf_counter()
    for _ in range(args.gen):
        out_tokens.append(tok.cpu().numpy())
        logits, state = lm.decode_step(model, tok, state)
        tok = _next(logits, cfg.vocab_size, args.temperature, gen)
    sync()
    decode_t = time.perf_counter() - t0

    gen_tokens = np.concatenate(out_tokens, axis=1)
    print(f"arch={cfg.name} batch={args.batch} device={device}")
    print(f"prefill: {args.prompt_len} steps in {prefill_t:.2f}s")
    print(f"decode:  {args.gen} tokens in {decode_t:.2f}s "
          f"({args.batch * args.gen / max(decode_t, 1e-9):.1f} tok/s)")
    print("sample generations (token ids):")
    for b in range(min(args.batch, 2)):
        print(f"  [{b}]", gen_tokens[b][:12].tolist())
    return gen_tokens


if __name__ == "__main__":
    main()
