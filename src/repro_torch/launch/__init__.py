"""Meshes and sharding policies of the port (``repro.launch``): the
``DeviceMesh`` builders (``mesh``) and the per-(arch x shape-kind) rules
tables (``sharding``). Importing touches no process group."""
from .mesh import batch_axes, make_host_mesh, make_production_mesh
from .sharding import needs_fsdp_for_serving, rules_for, serve_rules, train_rules

__all__ = ["batch_axes", "make_host_mesh", "make_production_mesh", "needs_fsdp_for_serving",
           "rules_for", "serve_rules", "train_rules"]
