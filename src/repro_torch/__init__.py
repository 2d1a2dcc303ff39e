"""repro_torch — the PyTorch/CUDA port of the ``repro`` package.

The host fabric (``core``, ``telemetry``, ``configs``, ``serving.batching``,
``cluster.accounting``) is kept as verbatim copies of the reference
modules, with only the package name changed; a test holds them equal.
The model path (``checkpoint``, ``models``, ``kernels``, ``serving``)
is written for PyTorch, with hand-written CUDA kernels for prefill and
decode attention on Hopper (``kernels/csrc``).

Entry points take ``device=`` and default to ``"cuda"``: they raise when
CUDA is absent unless the caller asks for ``device="cpu"``.
"""
