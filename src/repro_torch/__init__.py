"""DA-MolDQN in PyTorch for NVIDIA Hopper (H100): the port of ``repro``.

The JAX package ``repro`` is the reference; this package mirrors its
layout module for module, so ``repro_torch.X.Y`` is the counterpart of
``repro.X.Y``.  It imports ``torch`` and ``numpy`` and nothing of JAX or
``repro``.  NumPy-only modules (``chem``, ``core.reward``, ``core.rollout``,
...) are copies whose imports point here; device code runs on the card
through hand-written kernels under ``kernels/``.

Entry points take ``device=``; ``None`` means the GPU (``device.py``).
Ported so far: the molecule-optimization serving path
(``launch/serve_molopt.py`` -> ``serving/service.py`` ->
``kernels/fused_qnet``), the trainer (``core/distributed.py`` ->
``kernels/packed_qnet``), and the LM zoo's prefill and decode
(``launch/steps.py``, ``launch/serve.py`` -> ``models/`` ->
``kernels/flash_attention``, ``kernels/ssd_scan``).
"""
