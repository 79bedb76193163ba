"""The port's command-line entry points beyond the ball train and predict
CLIs (``train/__main__.py``, ``predict/__main__.py``): each module runs as
``python -m ball_action_spotting_torch.cli.<name>`` and mirrors one script
of the JAX package's ``scripts/``."""
