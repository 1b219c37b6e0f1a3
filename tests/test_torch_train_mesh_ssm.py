"""Sharded training of mamba2-370m and hymba-1.5b against the JAX
package's one-device step: ``test_torch_train_mesh_families.py``'s suite
(its docstring says what is held and at which tolerances) over these two
cases, in a module of their own so that pytest-xdist runs them beside the
MoE cases."""
from test_torch_train_mesh_families import family_suite

globals().update(family_suite(["mamba2-mb2", "hymba-mb1"]))
