"""Scale-out: process groups, the (data, model) mesh and the state layouts
(unite_tpu/parallel)."""
