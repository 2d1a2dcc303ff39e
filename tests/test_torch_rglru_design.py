"""The order in which the port's RG-LRU scan kernel (K3) walks its
inputs, mirrored in plain PyTorch on the CPU and held against the plain
version and the JAX package.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it
against its plain version bit for bit.  This file checks what surrounds
it before any card run:

* ``plan_scan``: the channel tiles and the ring of TMA boxes cover every
  (row, channel, step) exactly once, fill the card at one long prompt,
  stay inside a block's shared memory, and depend only on (B, S, r, SM
  count);
* a mirror that walks a and b as the kernel does (block by block, box by
  box through a ring of ``stages`` slots, zero-filled past S and r, one
  separately rounded multiply and add a step, each box's y stored whole
  and clipped at S and r) equals
  ``ref.rglru_scan_ref`` exactly and matches the Pallas kernel in
  interpret mode and ``repro.kernels.ref.ref_rglru_scan`` at 1e-6;
* ``check_inputs`` refuses what TMA cannot read, with ``ValueError``,
  and takes every configuration's RG-LRU width.

Inputs are made with numpy from a seed and handed to both packages.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ops import rglru_scan as pallas_rglru_scan  # noqa: E402
from repro.kernels.ref import ref_rglru_scan  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rglru_scan as kmod  # noqa: E402

KERNEL_TOL = dict(atol=1e-6, rtol=1e-6)
H100_SMS = 132
# (B, S, r): the timed shapes (main, one long prompt, four long prompts,
# the float32 gate's prompt) and small ones
SHAPES = [(4, 128, 2560), (1, 4096, 2560), (4, 2048, 2560), (1, 2100, 2560),
          (2, 77, 2500), (1, 300, 8), (3, 1, 64), (64, 128, 2560),
          (1, 1000, 100)]


def _rglru_widths():
    """Every configuration's RG-LRU width, full and reduced."""
    widths = {}
    for arch in list_archs():
        for cfg in (get_config(arch), get_config(arch).reduced()):
            if cfg.rglru is not None:
                widths[cfg.name] = cfg.rglru.d_rnn or cfg.d_model
    return widths


def _blocks(B, S, r, plan):
    """Each block's (row, channel range) and the step range of each of
    its boxes, in the order the kernel issues them."""
    boxes = -(-S // plan.steps)
    for row in range(B):
        for tile in range(plan.tiles):
            c0 = tile * plan.channels
            yield (row, c0, min(r, c0 + plan.channels),
                   [(j * plan.steps, min(S, (j + 1) * plan.steps))
                    for j in range(boxes)])


# ---------------------------------------------------------------------------
# the plan
@pytest.mark.parametrize("B,S,r", SHAPES)
@pytest.mark.parametrize("n_sm", [H100_SMS, 1, 16])
def test_plan_covers_every_row_channel_and_step_once(B, S, r, n_sm):
    plan = kmod.plan_scan(B, S, r, n_sm)
    assert plan.channels in kmod.TILE_CHANNELS
    assert plan.steps * plan.channels * 8 == kmod.STAGE_BYTES
    assert plan.tiles == -(-r // plan.channels)
    assert plan.blocks == B * plan.tiles
    assert 1 <= plan.stages <= kmod.MAX_STAGES
    assert plan.stages <= max(1, -(-S // plan.steps))
    if S > plan.steps:
        assert plan.stages >= 2             # one walked, one in flight
    count = np.zeros((B, S, r), np.int32)
    for row, c0, c1, boxes in _blocks(B, S, r, plan):
        assert c0 < r and c1 - c0 <= plan.channels
        for t0, t1 in boxes:
            assert 0 < t1 - t0 <= plan.steps
            count[row, t0:t1, c0:c1] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("B,S,r", SHAPES)
def test_plan_fits_a_block_and_reads_only_its_arguments(B, S, r):
    plan = kmod.plan_scan(B, S, r, H100_SMS)
    assert plan.smem_bytes <= kmod.SMEM_LIMIT == 232448
    # the ring, the staged y boxes (half a stage each), the barriers
    assert plan.smem_bytes == (kmod.SMEM_ALIGN + plan.stages * kmod.STAGE_BYTES
                               + kmod.Y_BUFFERS * kmod.STAGE_BYTES // 2
                               + 8 * plan.stages)
    assert plan == kmod.plan_scan(B, S, r, H100_SMS)
    assert list(inspect.signature(kmod.plan_scan).parameters) == [
        "B", "S", "r", "n_sm"]


def test_plan_fills_the_card_at_one_long_prompt():
    long = kmod.plan_scan(1, 4096, 2560, H100_SMS)
    assert long.blocks >= H100_SMS
    # the whole ring of blocks that share an SM fits its shared memory
    per_sm = -(-long.blocks // H100_SMS)
    assert per_sm * long.smem_bytes <= 228 * 1024
    # tens of KB of loads in flight on every SM: all stages but one
    assert (long.stages - 1) * kmod.STAGE_BYTES >= 32 * 1024
    # the main shape keeps at least as many blocks as one thread per
    # (row, channel) in blocks of 64 gave it (160)
    main = kmod.plan_scan(4, 128, 2560, H100_SMS)
    assert main.blocks >= 4 * 2560 // 64
    assert main.stages * main.steps >= 128      # every box in flight at once


# ---------------------------------------------------------------------------
# the kernel's walk, mirrored
def scan_mirror(a, b, h0, plan):
    """y, h_T as the kernel computes them: block by block, box by box
    through a ring of ``plan.stages`` slots refilled as the walk leaves
    them, each step a separately rounded multiply then add into a y box
    that is stored once walked."""
    B, S, r = a.shape
    C, T, K = plan.channels, plan.steps, plan.stages
    boxes = -(-S // T)
    y = torch.full((B, S, r), float("nan"))
    hT = torch.full((B, r), float("nan"))
    for row, c0, c1, _ in _blocks(B, S, r, plan):
        n = c1 - c0
        ring = [None] * K

        def issue(j):                     # TMA: zero past S and past r
            t0, t1 = j * T, min(S, (j + 1) * T)
            box = torch.zeros((2, T, C))
            box[0, :t1 - t0, :n] = a[row, t0:t1, c0:c1]
            box[1, :t1 - t0, :n] = b[row, t0:t1, c0:c1]
            assert ring[j % K] is None, "a stage refilled before it was walked"
            ring[j % K] = (j, box)

        for j in range(min(K, boxes)):
            issue(j)
        h = torch.zeros(C)
        if h0 is not None:
            h[:n] = h0[row, c0:c1]
        for j in range(boxes):
            got, box = ring[j % K]
            assert got == j, "the walk read a stage of another box"
            t0, t1 = j * T, min(S, (j + 1) * T)
            y_box = torch.full((T, C), float("nan"))
            for u in range(t1 - t0):
                h = torch.add(torch.mul(box[0, u], h), box[1, u])
                y_box[u] = h
            y[row, t0:t1, c0:c1] = y_box[:t1 - t0, :n]   # clipped at S, r
            ring[j % K] = None
            if j + K < boxes:
                issue(j + K)
        hT[row, c0:c1] = h[:n]
    return y, hT


def _inputs(seed, B, S, r, with_h0):
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, r))))).astype(
        np.float32)
    b = rng.standard_normal((B, S, r), dtype=np.float32)
    h0 = rng.standard_normal((B, r), dtype=np.float32) if with_h0 else None
    return a, b, h0


def _t(x):
    return None if x is None else torch.from_numpy(x.copy())


def _j(x):
    return None if x is None else jnp.asarray(x)


# S one below, at and one above a box and the ring's depth.  n_sm 1 puts
# every block on one SM, which shares RING_BYTES_PER_SM among them: (B 2,
# r 64) is 4 blocks of 32 channels, 32 steps a box, a ring of 4 stages
# (128 steps); (B 1, r 100) at 132 SMs is 7 blocks of 16 channels (the
# last one ragged), 64 steps a box, 16 stages (1024 steps)
EDGES = [(2, S, 64, 1) for S in (1, 31, 32, 33, 127, 128, 129, 2100)] + [
    (1, S, 100, H100_SMS) for S in (63, 64, 65, 1023, 1024, 1025)] + [
    (1, 300, 8, H100_SMS),                        # r below one tile
    (3, 70, 36, H100_SMS)]                        # ragged r, three rows


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("B,S,r,n_sm", EDGES)
def test_mirror_equals_plain_version_and_matches_jax(B, S, r, n_sm, with_h0):
    plan = kmod.plan_scan(B, S, r, n_sm)
    if (B, r, n_sm) == (2, 64, 1):
        assert (plan.channels, plan.steps) == (32, 32)
        assert plan.stages == min(4, -(-S // 32))
    elif (B, r) == (1, 100):
        assert (plan.channels, plan.steps) == (16, 64)
        assert plan.stages == min(16, -(-S // 64))
    a, b, h0 = _inputs(B * 7919 + S * 31 + r, B, S, r, with_h0)
    y, hT = scan_mirror(_t(a), _t(b), _t(h0), plan)
    wy, wh = ref.rglru_scan_ref(_t(a), _t(b), _t(h0))
    assert torch.equal(y, wy) and torch.equal(hT, wh)
    yo, ho = ref_rglru_scan(_j(a), _j(b), _j(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yo), **KERNEL_TOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(ho), **KERNEL_TOL)


@pytest.mark.parametrize("B,S,r,n_sm", [(2, 257, 64, 1), (1, 65, 100, H100_SMS),
                                        (1, 300, 8, H100_SMS)])
def test_mirror_matches_the_pallas_kernel_in_interpret_mode(B, S, r, n_sm):
    plan = kmod.plan_scan(B, S, r, n_sm)
    a, b, h0 = _inputs(S + r, B, S, r, True)
    y, hT = scan_mirror(_t(a), _t(b), _t(h0), plan)
    yk, hk = pallas_rglru_scan(_j(a), _j(b), _j(h0), r_blk=r, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yk), **KERNEL_TOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(hk), **KERNEL_TOL)


# ---------------------------------------------------------------------------
# what the kernel takes
def test_check_layout_takes_every_config_width():
    widths = _rglru_widths()
    assert widths["recurrentgemma-2b"] == 2560
    assert len(widths) >= 2                      # the full and reduced widths
    for name, r in widths.items():
        for B, S in ((1, 4096), (4, 128), (1, 1)):
            a = torch.zeros((B, S, r))
            kmod.check_layout(tuple(a.shape), a.stride(), 0)
        # the gates the model hands over are fresh contiguous tensors; on
        # the CPU only the device is refused
        a = torch.zeros((2, 8, r))
        with pytest.raises(ValueError, match="CUDA device"):
            kmod.check_inputs(a, a.clone(), torch.zeros((2, r)))


def test_check_inputs_refuses_what_tma_cannot_read():
    base = torch.zeros((2, 16, 12))
    flat = torch.zeros(2 * 16 * 12 + 1)
    cases = [
        (base[..., :10], "r % 4"),                            # r 10
        (torch.zeros((2, 16, 6)), "r % 4"),
        (base.transpose(1, 2), "contiguous"),                 # channel stride 12
        (flat[1:].view(2, 16, 12), "aligned"),                # base + 4 bytes
        (torch.zeros((2, 16, 10))[..., :8], "multiples of 16"),  # 40-byte steps
        (torch.zeros((2, 1, 8)).expand(2, 16, 8), "multiples of 16"),  # stride 0
    ]
    for bad, match in cases:
        with pytest.raises(ValueError, match=match):
            kmod.check_inputs(bad, bad, None)
    with pytest.raises(ValueError, match="contiguous"):
        kmod.check_inputs(base, base, torch.zeros((12, 2)).t())


def test_check_layout_ignores_strides_of_length_one_dimensions():
    # a (1, 1, r) slice of a wider tensor is never stepped over B or S
    kmod.check_layout((1, 1, 8), (1000, 3, 1), 0)
    with pytest.raises(ValueError):
        kmod.check_layout((2, 1, 8), (1001, 3, 1), 0)
