"""Serving CLI and the LM slot server (counterpart of
`repro/launch/serve.py`).

A fixed pool of B decode slots runs lock-step decode steps (one
`decode_step` over the whole batch); an empty slot is refilled from the
queue by a per-request prefill whose caches are spliced into the slot.
``--vision`` routes to the vision micro-batcher, `vision_serve.main`,
with every other flag passed through (the open stream's
``--arrival-rate`` / ``--trace`` / ``--sla-ms`` / ``--serving`` and
``--profile`` too).  The server runs on the card unless
``--device cpu`` asks for the CPU (the plain versions of the kernels).

  python -m repro_torch.launch.serve --arch recurrentgemma-2b
  python -m repro_torch.launch.serve --arch olmoe-1b-7b --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \
      --reduced --device cpu --requests 2 --batch 2 --max-new 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \
      --reduced --device cpu --requests 2 --batch 2 --max-new 4 --cache-len 32
  PYTHONPATH=src python -m repro_torch.launch.serve --vision --model swin_t \
      --full --mode both --no-fuse
  PYTHONPATH=src python -m repro_torch.launch.serve --vision --model tnt_s \
      --mode both --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --vision \
      --model deit_t,swin_t --arrival-rate 200 --sla-ms 500 --requests 16 \
      --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.vision_serve import resolve_device
from repro_torch.models import transformer as tr


class Request:
    def __init__(self, rid: int, prompt: np.ndarray, max_new: int):
        self.rid = rid
        self.prompt = prompt
        self.max_new = max_new
        self.generated: List[int] = []
        self.logits: List[np.ndarray] = []   # per token, when kept
        self.t_submit = time.time()
        self.t_done: Optional[float] = None


class SlotServer:
    """Lock-step continuous batching over B slots, on the device of
    ``params``, for every decoder fed tokens (any block kind, dense or
    MoE).  With ``keep_logits`` each request also keeps the (vocab,)
    float32 logits each of its tokens was chosen from.  An encoder-only
    config raises, as the JAX server's assert does; so does the
    ``tokens+image`` mode, whose prompts the slots cannot carry (the JAX
    server feeds tokens only): prefill and decode it through
    `launch.steps` with ``patch_embeds``."""

    def __init__(self, cfg, params, batch: int, cache_len: int, *,
                 keep_logits: bool = False):
        if not cfg.supports_decode:
            raise ValueError(f"{cfg.name} is encoder-only: no decode "
                             f"(run it through steps.make_forward_step)")
        if cfg.input_mode != "tokens":
            raise ValueError(
                f"{cfg.name}: the slot server feeds tokens only, not the "
                f"{cfg.input_mode!r} input mode; prefill and decode it "
                f"through launch.steps")
        self.cfg = cfg
        self.params = params
        self.b = batch
        self.cache_len = cache_len
        self.device = tr.param_device(params)
        self.keep_logits = keep_logits
        self.caches = tr.init_caches(cfg, batch, cache_len, self.device)
        self.pos = torch.zeros((batch,), dtype=torch.int32, device=self.device)
        self.cur_tok = torch.zeros((batch,), dtype=torch.int32,
                                   device=self.device)
        self.active: List[Optional[Request]] = [None] * batch
        self.prefill = steps_lib.make_prefill_step(cfg, cache_len,
                                                   with_logits=keep_logits)
        self.decode = steps_lib.make_decode_step(cfg, with_logits=keep_logits)
        self.prefill_s: List[float] = []   # host wall per prefill
        self.decode_s = 0.0                # host wall of all decode steps
        self.steps = 0
        self.decoded = 0                   # tokens of active slots, decoded

    def _keep(self, req: Request, logits: torch.Tensor) -> None:
        req.logits.append(logits[:self.cfg.vocab].float().cpu().numpy())

    def _prefill_one(self, slot: int, req: Request):
        """Prefill a single request and splice its caches into the slot."""
        t0 = time.perf_counter()
        tokens = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int32,
                                 device=self.device)[None]
        out = self.prefill(self.params, {"tokens": tokens})
        tok, caches1 = out[0], out[1]
        for c, c1 in zip(self.caches, caches1):
            for key in c:
                c[key][slot] = c1[key][0]
        self.pos[slot] = len(req.prompt)
        self.cur_tok[slot] = tok[0]
        req.generated.append(int(tok[0]))        # waits for the device
        if self.keep_logits:
            self._keep(req, out[2][0])
        self.active[slot] = req
        self.prefill_s.append(time.perf_counter() - t0)

    def step(self):
        t0 = time.perf_counter()
        out = self.decode(self.params, self.cur_tok, self.caches, self.pos)
        toks, self.caches = out[0], out[1]
        self.pos = self.pos + 1
        self.cur_tok = toks
        toks_np = toks.cpu().numpy()             # waits for the device
        for i, req in enumerate(self.active):
            if req is not None:
                self.decoded += 1
                req.generated.append(int(toks_np[i]))
                if self.keep_logits:
                    self._keep(req, out[2][i])
        self.decode_s += time.perf_counter() - t0
        self.steps += 1


def drain(server: SlotServer, queue: List[Request]) -> List[Request]:
    """Serve ``queue`` to completion: refill empty slots by prefill, step
    every slot, retire the requests that reached ``max_new`` tokens.
    Returns the requests in the order they finished."""
    pending = list(queue)
    done: List[Request] = []
    while pending or any(server.active):
        for slot in range(server.b):
            if server.active[slot] is None and pending:
                server._prefill_one(slot, pending.pop(0))
        server.step()
        for slot, req in enumerate(server.active):
            if req and len(req.generated) >= req.max_new:
                req.t_done = time.time()
                done.append(req)
                server.active[slot] = None
    return done


def make_requests(cfg, n: int, prompt_len: int, max_new: int,
                  seed: int) -> List[Request]:
    """``n`` requests with prompts of 4..prompt_len random tokens drawn
    from numpy's generator at ``seed`` (the JAX server's draws)."""
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, cfg.vocab,
                                    size=rng.integers(4, prompt_len + 1)),
                    max_new)
            for i in range(n)]


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--vision" in argv:                 # route to the vision micro-batcher
        from repro_torch.launch import vision_serve
        argv.remove("--vision")
        return vision_serve.main(argv)
    ap = argparse.ArgumentParser(prog="serve",
                                 description="Greedy LM serving over B slots.")
    ap.add_argument("--arch", default="stablelm-3b",
                    choices=configs.list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not cfg.supports_decode:
        raise SystemExit(f"[serve] {cfg.name} is encoder-only: no decode")
    if cfg.input_mode != "tokens":
        raise SystemExit(f"[serve] {cfg.name}: the slot server feeds tokens "
                         f"only, not the {cfg.input_mode!r} input mode")
    device = resolve_device(args.device)
    print(f"[serve] {cfg.name} reduced={args.reduced} on {device}")

    params = tr.init_params(cfg, args.seed, device)
    queue = make_requests(cfg, args.requests, args.prompt_len, args.max_new,
                          args.seed)
    server = SlotServer(cfg, params, args.batch, args.cache_len)
    t0 = time.time()
    done = drain(server, queue)
    dt = time.time() - t0
    decoded = sum(len(r.generated) for r in done)
    lat = [r.t_done - r.t_submit for r in done]
    stats = {"arch": cfg.name, "device": str(device), "requests": len(done),
             "tokens": decoded, "seconds": dt, "tok_s": decoded / dt,
             "steps": server.steps,
             "decode_tok_s": server.decoded / server.decode_s,
             "prefill_ms_mean": 1e3 * float(np.mean(server.prefill_s)),
             "latency_mean_s": float(np.mean(lat)),
             "generated": [list(r.generated) for r in
                           sorted(done, key=lambda r: r.rid)]}
    print(f"[serve] {len(done)} requests, {decoded} tokens in {dt:.2f}s -> "
          f"{stats['tok_s']:.1f} tok/s, {server.steps} decode steps, mean "
          f"prefill {stats['prefill_ms_mean']:.1f} ms, mean latency "
          f"{stats['latency_mean_s']:.2f}s")
    return stats


if __name__ == "__main__":
    main()
