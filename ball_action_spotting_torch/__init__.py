"""ball_action_spotting_torch — the PyTorch / CUDA port of the spotting stack.

A second package beside the JAX reference (``ball_action_spotting_tpu``),
written for one NVIDIA H100. It imports ``torch`` and never JAX nor anything
of the JAX package: host modules it needs are its own copies. Module names
and parameter layouts mirror the JAX package, so each counterpart is easy to
find and ``convert.py`` maps one state onto the other.

Layering (this slice: full-match offline inference with the flagship):

- ``core``     stack index windows, peak postprocessing, spotting-JSON IO.
- ``data``     host frame sources (synthetic, gray store, OpenCV).
- ``ops``      hand-written Hopper kernels (``csrc/*.cu``) behind wrappers
               that run the plain PyTorch version on CPU tensors.
- ``models``   EfficientNetV2 encoder, 3D blocks, GeM, ``MultiDimStacker``,
               BN folding.
- ``train``    checkpoint loading (the JAX package's ``.ckpt`` format).
- ``predict``  the chunked whole-video engine and the games pipeline.

Entry points take ``device=`` (default ``"cuda"``) and raise when no GPU is
present unless the caller asked for ``"cpu"``.
"""

__version__ = "0.1.0"
