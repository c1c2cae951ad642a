"""LAQ on PyTorch and CUDA: the port of ``repro`` (JAX/Pallas) to one
NVIDIA H100.

The layout mirrors ``src/repro/`` so each module's counterpart sits at the
same path (``repro/core/wire.py`` -> ``repro_torch/core/wire.py``).  This
package imports torch, numpy and the standard library only.  Entry points
take ``device=`` and default to ``"cuda"``; without a card they raise
unless the caller passes ``device="cpu"`` (see :mod:`repro_torch.device`).

Package ``__init__`` files re-export nothing, so importing a leaf module
never drags in the rest of the package (the kernel layer and the wire
import each other's neighbours).
"""
