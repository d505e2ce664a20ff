"""BrainSlug on PyTorch + CUDA: the depth-first stack compiler of
``repro`` (the JAX package) ported to an NVIDIA H100.

The layout mirrors ``repro`` module for module (``repro_torch/core/ir.py``
sits opposite ``repro/core/ir.py``, and so on).  Tensors keep the JAX
package's layouts at every public function: NHWC activations, HWIO conv
weights, ``(C,)`` per-channel vectors, ``(..., F)`` row chains.

Entry points run on ``cuda`` unless the caller asks for ``cpu``
(``OptimizeConfig(torch_device="cpu")``).  On the card, ``brainslug`` mode
runs the hand-written Hopper kernels of :mod:`repro_torch.kernels`; on the
CPU it runs their plain PyTorch versions and records ``fwd_reference``.
"""
