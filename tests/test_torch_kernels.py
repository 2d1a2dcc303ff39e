"""The port's plain attention versions (``repro_torch.kernels.ref``) held
against the reference's jnp oracles (``repro.models.layers``) and its
Pallas kernels in interpret mode, on the sweep of ``test_kernels.py``;
and the port's ``ops`` dispatch on CPU tensors.

Inputs are made with numpy from a seed and handed to both packages; for
bfloat16 both see the same rounded values.  The CUDA kernels themselves
are held against these plain versions on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ops import decode_attention as pallas_decode  # noqa: E402
from repro.kernels.ops import flash_attention as pallas_flash  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(rng, shape, dtype):
    """The same values as a jnp array and a torch tensor of ``dtype``."""
    x = jnp.asarray(rng.standard_normal(shape, dtype=np.float32)).astype(
        JNP[dtype])
    t = torch.from_numpy(np.array(x.astype(jnp.float32))).to(TORCH[dtype])
    return x, t


def _qkv(seed, B, Sq, Sk, Hq, Hkv, dh, dtype, dv=None):
    rng = np.random.default_rng(seed)
    q = _pair(rng, (B, Sq, Hq, dh), dtype)
    k = _pair(rng, (B, Sk, Hkv, dh), dtype)
    v = _pair(rng, (B, Sk, Hkv, dv or dh), dtype)
    return q, k, v


def _close(port, want, dtype, **extra):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(want, np.float32),
                               **{**TOL[dtype], **extra})


@pytest.mark.parametrize("B,S,Hq,Hkv,dh", [
    (1, 128, 4, 4, 32),      # MHA
    (2, 256, 8, 2, 64),      # GQA
    (1, 512, 2, 1, 128),     # MQA
    (3, 192, 6, 3, 48),      # odd-ish sizes
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_ref_sweep(B, S, Hq, Hkv, dh, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(0, B, S, S, Hq, Hkv, dh, dtype)
    port = ref.flash_attention_ref(tq, tk, tv)
    _close(port, pallas_flash(jq, jk, jv, q_blk=64, kv_blk=64,
                              interpret=True), dtype)
    _close(port, jlayers.flash_attention(jq, jk, jv, q_chunk=64,
                                         kv_chunk=64), dtype)


@pytest.mark.parametrize("window,softcap", [(None, None), (64, None),
                                            (None, 25.0), (96, 50.0)])
def test_flash_ref_window_softcap(window, softcap):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 2, 256, 256, 4, 2, 64, "float32")
    port = ref.flash_attention_ref(tq, tk, tv, window=window, softcap=softcap)
    _close(port, pallas_flash(jq, jk, jv, window=window, softcap=softcap,
                              q_blk=64, kv_blk=64, interpret=True), "float32")
    _close(port, jlayers.flash_attention(jq, jk, jv, window=window,
                                         softcap=softcap, q_chunk=64,
                                         kv_chunk=64), "float32")


def test_flash_ref_noncausal():
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 1, 128, 128, 4, 4, 32, "float32")
    port = ref.flash_attention_ref(tq, tk, tv, causal=False)
    _close(port, pallas_flash(jq, jk, jv, causal=False, q_blk=32, kv_blk=32,
                              interpret=True), "float32")
    _close(port, jlayers.flash_attention(jq, jk, jv, causal=False,
                                         q_chunk=32, kv_chunk=32), "float32")


@pytest.mark.parametrize("window", [None, 48])
def test_flash_ref_q_offset(window):
    """A query suffix at positions 128..191 of 192 keys, against the
    jnp oracle's own ``q_offset``."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(3, 2, 64, 192, 4, 2, 32, "float32")
    port = ref.flash_attention_ref(tq, tk, tv, window=window, q_offset=128)
    _close(port, jlayers.flash_attention(jq, jk, jv, window=window,
                                         q_chunk=64, kv_chunk=64,
                                         q_offset=128), "float32")


@pytest.mark.parametrize("Sq,Sk,causal,window,q_offset", [
    (128, 64, True, 16, 0),       # rows 79.. see no key
    (64, 64, False, 16, 100),     # every row sees no key
])
def test_flash_ref_rows_without_keys(Sq, Sk, causal, window, q_offset):
    """A row that sees no key is the mean of v over all keys, as the jnp
    oracle's finite NEG_INF makes it (the CUDA kernel matches this)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(10, 1, Sq, Sk, 4, 2, 32, "float32")
    port = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                                   q_offset=q_offset)
    _close(port, jlayers.flash_attention(jq, jk, jv, causal=causal,
                                         window=window, q_chunk=64,
                                         kv_chunk=64, q_offset=q_offset),
           "float32")
    mean_v = tv.float().mean(dim=1)                        # (B, Hkv, dv)
    np.testing.assert_allclose(port[0, -1].numpy(),
                               mean_v[0].repeat_interleave(2, 0).numpy(),
                               **TOL["float32"])


def test_flash_ref_head_dims_differ():
    (jq, tq), (jk, tk), (jv, tv) = _qkv(4, 1, 128, 128, 4, 2, 64, "float32",
                                        dv=32)
    port = ref.flash_attention_ref(tq, tk, tv)
    assert port.shape == (1, 128, 4, 32)
    _close(port, jlayers.flash_attention(jq, jk, jv, q_chunk=64,
                                         kv_chunk=64), "float32")


@pytest.mark.parametrize("B,S,Hq,Hkv,dh", [
    (2, 256, 4, 2, 64), (1, 512, 8, 8, 32), (4, 128, 2, 1, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_ref_sweep(B, S, Hq, Hkv, dh, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(5, B, 1, S, Hq, Hkv, dh, dtype)
    pos = np.random.default_rng(6).integers(1, S, size=(B,)).astype(np.int32)
    port = ref.decode_attention_ref(tq, tk, tv, torch.from_numpy(pos))
    jpos = jnp.asarray(pos)
    _close(port, pallas_decode(jq, jk, jv, jpos, kv_blk=64, interpret=True),
           dtype)
    _close(port, jlayers.decode_attention(jq, jk, jv, jpos), dtype)


@pytest.mark.parametrize("p", [3, 63, 64, 5 * 64 + 7])   # before/at/after wrap
def test_decode_ref_ring_buffer(p):
    B, W = 2, 64
    (jq, tq), (jk, tk), (jv, tv) = _qkv(7, B, 1, W, 4, 2, 32, "float32")
    pos = np.full((B,), p, np.int32)
    port = ref.decode_attention_ref(tq, tk, tv, torch.from_numpy(pos),
                                    window=W)
    jpos = jnp.asarray(pos)
    _close(port, pallas_decode(jq, jk, jv, jpos, window=W, kv_blk=32,
                               interpret=True), "float32")
    _close(port, jlayers.decode_attention(jq, jk, jv, jpos, window=W),
           "float32")


@pytest.mark.parametrize("S,window,pos", [
    (256, 64, [400, 100]),        # past a plain window
    (128, None, [-1, 5]),         # before the first slot
    (64, 64, [-3, -3]),           # ring buffer before the first write
])
def test_decode_ref_rows_without_slots(S, window, pos):
    """A row that sees no slot is the mean of v over all slots, as in the
    jnp oracle and the Pallas kernel (the CUDA kernel matches this)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(11, 2, 1, S, 4, 2, 32, "float32")
    pos = np.array(pos, np.int32)
    port = ref.decode_attention_ref(tq, tk, tv, torch.from_numpy(pos),
                                    window=window)
    jpos = jnp.asarray(pos)
    _close(port, pallas_decode(jq, jk, jv, jpos, window=window, kv_blk=32,
                               interpret=True), "float32")
    _close(port, jlayers.decode_attention(jq, jk, jv, jpos, window=window),
           "float32")
    mean_v = tv.float().mean(dim=1)                        # (B, Hkv, dv)
    np.testing.assert_allclose(port[0, 0].numpy(),
                               mean_v[0].repeat_interleave(2, 0).numpy(),
                               **TOL["float32"])


def test_decode_ref_window_softcap():
    """A plain (non-ring) window, with a softcap."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(8, 2, 1, 256, 4, 2, 64, "float32")
    pos = np.array([200, 17], np.int32)
    port = ref.decode_attention_ref(tq, tk, tv, torch.from_numpy(pos),
                                    window=64, softcap=30.0)
    _close(port, jlayers.decode_attention(jq, jk, jv, jnp.asarray(pos),
                                          window=64, softcap=30.0),
           "float32")


# ---------------------------------------------------------------------------
# dispatch
def test_ops_cpu_goes_to_plain_versions_without_launching():
    (_, tq), (_, tk), (_, tv) = _qkv(9, 1, 64, 64, 4, 2, 32, "float32")
    before = (ops.flash_attention.launches, ops.decode_attention.launches)
    out = ops.flash_attention(tq, tk, tv, window=32, softcap=20.0)
    torch.testing.assert_close(
        out, ref.flash_attention_ref(tq, tk, tv, window=32, softcap=20.0),
        rtol=0, atol=0)
    pos = torch.tensor([10], dtype=torch.int32)
    dec = ops.decode_attention(tq[:, :1], tk, tv, pos)
    torch.testing.assert_close(
        dec, ref.decode_attention_ref(tq[:, :1], tk, tv, pos), rtol=0, atol=0)
    assert (ops.flash_attention.launches,
            ops.decode_attention.launches) == before


def test_ops_refuses_other_and_mixed_devices():
    q = torch.zeros((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError):
        ops.flash_attention(q, q[:, :, :1], q[:, :, :1])
    k = torch.zeros((1, 8, 1, 16))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, k)


def test_force_reference_is_scoped():
    assert not ops.reference_forced()
    with ops.force_reference():
        with ops.force_reference():
            assert ops.reference_forced()
        assert ops.reference_forced()
    assert not ops.reference_forced()


def test_kernel_build_raises_without_nvcc(tmp_path, monkeypatch):
    """No fallback hides a missing toolkit: the build raises."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    lib = ops.KernelLibrary(tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        lib.load()


def test_kernel_wrappers_check_inputs():
    """The host wrappers refuse what the kernels do not take."""
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    q = torch.zeros((1, 8, 3, 16))
    k = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="multiple"):
        fmod.check_inputs(q, k, k, None, 0)
    q = torch.zeros((1, 8, 2, 16), dtype=torch.float16)
    with pytest.raises(TypeError):
        fmod.check_inputs(q, q, q, None, 0)
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fmod.check_inputs(q, q, q, None, 0)
    with pytest.raises(TypeError, match="int32"):
        dmod.check_inputs(q[:, :1], q, q, torch.zeros(1, dtype=torch.int64),
                          None)
