"""Device work of the port: the frame engine and its branch axis
(``resim``), the speculation cache (``speculation``), packed uploads
(``packing``), the many-worlds waves (``batch``) and the checksum fold
kernel (``checksum_fold``).

The package exports the JAX package's 13 names.  They resolve on first
use (``snapshot.checksum`` imports this package's ``checksum_fold`` while
``resim`` imports ``snapshot.checksum``, so an eager import here would be
a cycle).  ``resim`` is the module ``ops.resim``, which is callable as
the function :func:`~.resim.resim`."""

from importlib import import_module

_HOME = {
    "make_batched_resim_fn": "batch",
    "stack_worlds": "batch",
    "unstack_world": "batch",
    "probe_program_variants": "variant_probe",
    "VariantProbeReport": "variant_probe",
    "StepCtx": "resim",
    "advance": "resim",
    "make_advance_fn": "resim",
    "make_resim_fn": "resim",
    "make_speculate_fn": "resim",
    "select_branch": "resim",
    "slice_frame": "resim",
}

__all__ = [
    "make_batched_resim_fn",
    "stack_worlds",
    "unstack_world",
    "probe_program_variants",
    "VariantProbeReport",
    "StepCtx",
    "advance",
    "resim",
    "make_advance_fn",
    "make_resim_fn",
    "make_speculate_fn",
    "select_branch",
    "slice_frame",
]


def __getattr__(name: str):
    if name == "resim":
        return import_module(".resim", __name__)
    home = _HOME.get(name)
    if home is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(import_module(f".{home}", __name__), name)
    globals()[name] = value
    return value
