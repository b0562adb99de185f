"""Distributed solvers on `torch.distributed` (port of
`openmavis_tpu/parallel/`): the sharded bundle adjustments (`dist_ba`),
sharded place scores (`dist_place`) and the multi-process runtime
(`multihost`). One rank per device; every rank runs the same call."""

from . import dist_ba  # noqa: F401
