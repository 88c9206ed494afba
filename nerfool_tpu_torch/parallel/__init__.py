"""One process per card (port of the JAX package's ``parallel``):
``distributed.py`` joins the ``torch.distributed`` group and holds the
per-rank index and seed arithmetic, ``mesh.py`` the ray split that the
attack step, the whole-frame render and the trainer take."""
