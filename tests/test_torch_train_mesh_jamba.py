"""Sharded training of jamba-1.5-large (one group of its pattern:
attention, 7 Mamba2 layers, 4 MoE FFNs) against the JAX package's
one-device step: ``test_torch_train_mesh_families.py``'s suite (its
docstring says what is held and at which tolerances) over this case, in a
module of its own so that pytest-xdist runs it beside the others."""
from test_torch_train_mesh_families import family_suite

globals().update(family_suite(["jamba-mb2"]))
