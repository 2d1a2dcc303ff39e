"""Out-of-process model endpoints in the port, on the CPU — the port-side
mirror of ``tests/test_backend.py``'s ``spec_ref`` test:

* a reduced torch endpoint deployed with ``spec_ref`` on the subprocess
  and the snapshot backends scores within 1e-5 of the thread backend,
  with identical argmax; after a freshen its invoke pays nothing inline,
  and the pool's stats name the backend;
* building a ``ModelEndpoint`` for ``device="cuda"`` and its spec makes
  no ``torch.cuda`` call: the snapshot template builds them before it
  forks, and CUDA does not survive a fork;
* without ``spec_ref`` an out-of-process deploy raises the
  ``BackendError`` that names ``FunctionSpec.ref``.

Each worker and template process imports this module to resolve the
``spec_ref`` (``endpoint_spec``), so its top level imports no JAX.  The
store's directory reaches them through the environment, which the
backends pass on.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import BackendError, PoolConfig  # noqa: E402
from repro_torch.models import make_model  # noqa: E402
from repro_torch.serving import (Executor, ModelEndpoint,  # noqa: E402
                                 ServingEngine, WeightStore)

NAME, B, SEQ = "tinyproc", 2, 8
STORE_ENV = "REPRO_TORCH_TEST_STORE"
SPEC_REF = "test_torch_backends:endpoint_spec"


def _cfg():
    return dataclasses.replace(get_config("qwen2-0.5b").reduced(d_model=128),
                               vocab_size=256, dtype="float32")


def _endpoint(root, device="cpu", spec_ref=SPEC_REF):
    return ModelEndpoint(NAME, _cfg(), WeightStore(root), Executor(),
                         batch_size=B, seq_len=SEQ, device=device,
                         spec_ref=spec_ref)


def endpoint_spec():
    """The factory a worker imports and calls: the same endpoint, on the
    store the parent published to."""
    return _endpoint(os.environ[STORE_ENV]).spec()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Weights from a seeded torch init, published once; the prompt's
    logits on the thread backend."""
    root = str(tmp_path_factory.mktemp("backends"))
    params = make_model(_cfg(), device="cpu").init(
        torch.Generator().manual_seed(0))
    WeightStore(root).publish(NAME, params)
    prompt = np.random.default_rng(0).integers(0, 256, (B, SEQ)).astype(
        np.int32)
    eng = ServingEngine()
    try:
        eng.deploy(_endpoint(root))
        want = eng.invoke(NAME, prompt, freshen_successors=False)["logits"]
    finally:
        eng.close()
    return root, prompt, want


@pytest.mark.parametrize("backend", ["subprocess", "snapshot"])
def test_spec_ref_endpoint_matches_thread_backend(served, backend,
                                                  monkeypatch):
    root, prompt, want = served
    monkeypatch.setenv(STORE_ENV, root)
    eng = ServingEngine()
    try:
        rt = eng.deploy(_endpoint(root), backend=backend,
                        pool_config=PoolConfig(max_instances=2,
                                               keep_alive=600.0))
        assert rt.backend.name == backend and rt.fr_state is None
        rt.freshen(blocking=True)
        out = eng.invoke(NAME, prompt, freshen_successors=False)
        stats = rt.freshen_stats()
        assert stats["freshened"] >= 3 and stats["inline"] == 0
        assert out["logits"].shape == want.shape
        np.testing.assert_allclose(out["logits"], want, atol=1e-5, rtol=0)
        assert np.array_equal(out["logits"].argmax(-1), want.argmax(-1))
        warm = eng.invoke(NAME, prompt, freshen_successors=False)
        assert np.array_equal(warm["logits"], out["logits"])
        pool = eng.platform_stats()[NAME]
        assert pool["backend"] == backend and pool["instances"] == 1
        assert eng.scheduler.pool(NAME).measured_cold_start() > 0.0
    finally:
        eng.close()
    assert not rt.backend.alive(rt)


def test_endpoint_and_spec_touch_no_cuda(tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("building an endpoint touched CUDA")

    for name in ("is_available", "current_device", "init"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    ep = _endpoint(str(tmp_path), device="cuda")
    spec = ep.spec()
    assert spec.ref == SPEC_REF and spec.name == NAME
    assert ep.requested_device == "cuda"


@pytest.mark.parametrize("backend", ["subprocess", "snapshot"])
def test_out_of_process_deploy_needs_spec_ref(tmp_path, backend):
    eng = ServingEngine()
    try:
        with pytest.raises(BackendError, match="FunctionSpec.ref"):
            eng.deploy(_endpoint(str(tmp_path), spec_ref=None),
                       backend=backend)
    finally:
        eng.close()
