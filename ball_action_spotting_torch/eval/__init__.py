"""SoccerNet average-mAP evaluation and submission packaging (copy of the
JAX package's ``eval/``)."""
