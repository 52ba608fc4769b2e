"""audiojax_torch — the PyTorch/CUDA port of audiojax for NVIDIA Hopper.

The package mirrors ``audiojax``'s layout (``dsp``, ``nn``, ``ops``,
``models``, ``importers``, ``runtime``, ``utils``) with the same module and function
names, so each port module has exactly one counterpart in the JAX package.  It imports
torch and numpy only: never ``jax`` and nothing of ``audiojax``.

Entry points run on the card (``device="cuda"``) unless the caller asks for
``device="cpu"``; see :mod:`audiojax_torch.device`.  The kernels (STFT,
ISTFT, depthwise conv1d, relu² attention, rel-pos attention scores) are
hand-written CUDA C++ under ``csrc/``, built with ``nvcc`` at first use.
"""
