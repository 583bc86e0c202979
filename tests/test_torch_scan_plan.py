"""The RG-LRU scan's launch plan (`kernels/rglru_scan.py::scan_plan`) on
the CPU.  T up to one chunk (32 steps in fp32, 64 in bf16: the served
prompts) is one walk launch, a thread per (sequence, channel), with no
scratch; longer T is cut into chunks, one block per (chunk, run of 128
channels of one sequence), whose chunks cover T and whose runs cover
every channel of every sequence, with the look-back's scratch sized to
hold three floats per (chunk, sequence, channel) (its flags live in a
buffer of their own).  T and W are ragged: the ring prompt's 2,100 tokens, W 100."""

import pytest
import torch

from repro_torch.kernels.rglru_scan import SCAN_CHANNELS, ScanPlan, scan_plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", [100, 2560])
@pytest.mark.parametrize("b", [1, 2, 3, 4])
@pytest.mark.parametrize("t", [1, 13, 32, 33, 64, 65, 2100, 4096])
def test_chunks_and_runs_cover_the_input(t, b, w, dtype):
    p = scan_plan(b, t, w, dtype)
    chunk = 32 if dtype == torch.float32 else 64
    assert isinstance(p, ScanPlan)
    if t <= chunk:
        assert (p.chunk, p.channels, p.chunks, p.scratch) == (t, 64, 1, 0)
        assert (p.runs - 1) * 64 < b * w <= p.runs * 64
        return
    assert (p.chunk, p.channels) == (chunk, SCAN_CHANNELS)
    assert (p.chunks - 1) * p.chunk < t <= p.chunks * p.chunk
    per_seq = -(-w // SCAN_CHANNELS)
    assert p.runs == b * per_seq
    assert (per_seq - 1) * SCAN_CHANNELS < w <= per_seq * SCAN_CHANNELS
    assert p.scratch == 3 * p.chunks * b * w * 4


def test_the_timed_shapes():
    """chip_smoke.py's rows: T 13 walks (40 blocks of 64 at W 2560), the
    ring prompt's 2,100 tokens take 66 chunks in fp32 (33 in bf16) and T
    4,096 128 (64), each over 20 runs."""
    assert scan_plan(1, 13, 2560) == ScanPlan(13, 64, 1, 40, 0)
    long = scan_plan(1, 4096, 2560)
    assert (long.chunks, long.runs) == (128, 20)
    assert long.scratch == 3 * 128 * 2560 * 4
    assert scan_plan(1, 2100, 2560)[2:4] == (66, 20)
    assert scan_plan(1, 4096, 2560, torch.bfloat16)[:4] == (64, 128, 64, 20)
    assert scan_plan(1, 2100, 2560, torch.bfloat16)[2:4] == (33, 20)


def test_the_walk_can_be_asked_for_at_any_t():
    """The one-thread-per-channel walk, the design before the chunked
    scan, at the ring prompt's length (what chip_smoke.py times beside
    the chunked scan)."""
    assert scan_plan(1, 2100, 2560, walk=True) == ScanPlan(2100, 64, 1, 40,
                                                           0)


def test_a_chunk_is_128_bytes_of_a_channel():
    """A bf16 chunk holds twice the steps of an fp32 one, so the same
    bytes: half the chunks, the same runs."""
    p32, p16 = scan_plan(2, 300, 100), scan_plan(2, 300, 100, torch.bfloat16)
    assert (p32.chunk, p16.chunk) == (32, 64)
    assert (p32.chunks, p16.chunks) == (10, 5) and p32.runs == p16.runs


@pytest.mark.parametrize("args", [(0, 13, 100), (1, 0, 100), (1, 13, 0)])
def test_empty_or_bad_shapes_raise(args):
    with pytest.raises(ValueError):
        scan_plan(*args)
    with pytest.raises(ValueError):
        scan_plan(1, 13, 100, torch.float16)
