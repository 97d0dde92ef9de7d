"""paddle_tpu_torch.jit: ``to_static`` as CUDA-graph capture (port of
``paddle_tpu/jit/__init__.py``).

The reference turns a decorated function into one compiled XLA program;
the port captures it into CUDA graphs and replays them
(:mod:`paddle_tpu_torch.jit.api`). ``save``, ``load`` and
``TranslatedLayer`` are not ported yet (ROADMAP.md A.3.2: they need the
kernels registered as ``torch.library`` ops for ``torch.export``); nor is
``dy2static``'s conversion of device-predicated control flow.
"""

from paddle_tpu_torch.jit.api import (  # noqa: F401
    InputSpec, StaticFunction, enable_to_static, ignore_module,
    not_to_static, to_static,
)

__all__ = ["to_static", "not_to_static", "enable_to_static", "save", "load",
           "StaticFunction", "InputSpec", "ignore_module"]

_NOT_PORTED = ("jit.save, jit.load and TranslatedLayer are not ported yet "
               "(ROADMAP.md A.3.2: they need the kernels registered as "
               "torch.library ops for torch.export)")


def save(layer, path, input_spec=None, **configs):
    """Not ported (ROADMAP.md A.3.2)."""
    raise NotImplementedError(_NOT_PORTED)


def load(path, **configs):
    """Not ported (ROADMAP.md A.3.2)."""
    raise NotImplementedError(_NOT_PORTED)


class TranslatedLayer:
    """Not ported (ROADMAP.md A.3.2)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED)


def set_code_level(level=100, also_to_stdout=False):
    """The reference's ``set_code_level``: the level of the dy2static
    logger (DEBUG when ``level > 0``)."""
    import logging
    logging.getLogger("paddle_tpu_torch.jit.dy2static").setLevel(
        logging.DEBUG if level > 0 else logging.WARNING)


def set_verbosity(level=0, also_to_stdout=False):
    """The reference's ``set_verbosity``: the level of the jit logger,
    which logs each capture and why a program runs eagerly (DEBUG when
    ``level > 0``)."""
    import logging
    logging.getLogger("paddle_tpu_torch.jit").setLevel(
        logging.DEBUG if level > 0 else logging.WARNING)


__all__ += ["TranslatedLayer", "set_code_level", "set_verbosity"]
