"""Backbone training (port of ``nerfool_tpu/train``): ``trainer.py`` holds
the train step, plain and adversarial, and the ``Trainer`` that streams
views, logs and checkpoints; ``python -m nerfool_tpu_torch.train`` is its
command line (``__main__.py``)."""
