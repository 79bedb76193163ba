"""ball_action_spotting_torch — the PyTorch / CUDA port of the spotting stack.

A second package beside the JAX reference (``ball_action_spotting_tpu``),
written for one NVIDIA H100. It imports ``torch`` and never JAX nor anything
of the JAX package: host modules it needs are its own copies. Module names
and parameter layouts mirror the JAX package, so each counterpart is easy to
find and ``convert.py`` maps one state onto the other.

Layering:

- ``domains``  the ball-action and action task descriptors and splits.
- ``core``     stack index windows, peak postprocessing, spotting-JSON IO,
               the ensemble blend, labels, sampling weights, targets.
- ``data``     host frame sources (synthetic, gray store, OpenCV), clip
               datasets and the loader.
- ``ops``      hand-written Hopper kernels (``csrc/*.cu``) behind wrappers
               that run the plain PyTorch version on CPU tensors.
- ``models``   EfficientNetV2 encoder, 3D blocks, GeM, ``MultiDimStacker``,
               BN folding.
- ``train``    the single-device trainer, its steps and checkpoints (the JAX
               package's ``.ckpt`` format) and the ball training CLI.
- ``predict``  the chunked whole-video engine, the games pipeline and the
               ball predict CLI.
- ``eval``     average-mAP (official SoccerNet algorithm and the matcher)
               and the submission zip.
- ``cli``      the evaluate, ensemble and submission CLIs of the ball task
               and the train, predict and evaluate CLIs of the action task.

Entry points take ``device=`` (default ``"cuda"``) and raise when no GPU is
present unless the caller asked for ``"cpu"``.
"""

__version__ = "0.1.0"
