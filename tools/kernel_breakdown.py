"""Device time of the LM decode attention and the fused MLP on the card,
split by CUDA kernel (the main kernel and its combine / finish kernel),
at the shapes `chip_smoke.py` times them: RecurrentGemma-2B's decode over
128 and 2048 cache slots and its gated MLP at 4 and 13 rows, and the
vision MLPs at DeiT-T b8 (fp32, bf16 weights on fp32 x, bf16), Swin-T
stages 1 and 4 and ViT-B/16 b2 (fp32).  Each line gives the total and
every kernel's mean device time per call over 20 calls under
torch.profiler, and for the vision MLPs the max error against the plain
version.

Run from the root of a checkout on a machine with a card:
    python3 tools/kernel_breakdown.py
"""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def breakdown(name: str, fn, iters: int = 20) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key[:60], e.self_device_time_total / iters / 1e3)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    print(f"{name}: total {sum(ms for _, ms in rows):.4f} ms | "
          + " | ".join(f"{k} {ms:.4f}" for k, ms in rows), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_breakdown: no CUDA device is available")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build, fused_mlp as fm
    from repro_torch.kernels import head_attention as ha, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    card = torch.cuda.get_device_name(0)
    print(f"[kernel_breakdown] {card}, torch {torch.__version__}")
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(shape, dt, s=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * s).to(dt)

    bf, f32 = torch.bfloat16, torch.float32
    for dt in (bf, f32):
        for s_len in (128, 2048):
            q = rand((4, 10, 256), dt)
            kc, vc = rand((4, 1, s_len, 256), dt), rand((4, 1, s_len, 256), dt)
            lengths = torch.tensor([1, s_len // 2 + 5, s_len, s_len // 3],
                                   dtype=torch.int32, device="cuda")
            breakdown(f"decode_attention B 4, Hq 10 / Hkv 1, Dh 256, "
                      f"S {s_len} {dt}",
                      lambda: ha.decode_attention(q, kc, vc, lengths))
    for dt in (bf, f32):
        for n in (4, 13):
            d, m = 2560, 7680
            x = rand((n, d), dt)
            w1, wg = rand((d, m), dt, d ** -.5), rand((d, m), dt, d ** -.5)
            w2 = rand((m, d), dt, m ** -.5)
            breakdown(f"fused_mlp gated N {n} D {d} M {m} {dt}",
                      lambda: fm.fused_mlp(x, w1, w2, w_gate=wg))
    for (rows, d, m, d_out), modes in (
            ((1568, 192, 768, 192), ("fp32", "mixed", "bf16")),
            ((25088, 96, 384, 96), ("fp32",)),
            ((392, 768, 3072, 768), ("fp32",)),
            ((512, 768, 3072, 768), ("fp32",))):
        for mode in modes:
            xd = bf if mode == "bf16" else f32
            wd = f32 if mode == "fp32" else bf
            x = rand((rows, d), xd)
            w1, w2 = rand((d, m), wd, d ** -.5), rand((m, d_out), wd, m ** -.5)
            b1, b2 = rand((m,), wd, .1), rand((d_out,), wd, .1)
            want = ref.fused_mlp_ref(x, w1, b1, w2, b2)
            err = float((fm.fused_mlp(x, w1, w2, b1, b2).float()
                         - want.float()).abs().max())
            breakdown(f"fused_mlp {rows}x{d}x{m}x{d_out} {mode} (max|err| "
                      f"{err:.2e} at scale {float(want.float().abs().max()):.2f})",
                      lambda: fm.fused_mlp(x, w1, w2, b1, b2))


if __name__ == "__main__":
    main()
