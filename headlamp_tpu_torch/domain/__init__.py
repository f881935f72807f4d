"""Pure domain layer: TPU + Intel GPU providers over plain k8s dicts."""

from . import accelerator, constants, intel, objects, tpu  # noqa: F401
