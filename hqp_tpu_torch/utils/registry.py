"""Named-module registry: runtime-exchangeable solver components.

The reference makes every solver component exchangeable by string name at
runtime through its Tcl layer (IF_CLASS_DEFINE / IF_MODULE in
iftcl/If_Class.h, iftcl/If_Module.h; e.g. ``sqp_solver Powell``,
``qp_mat_solver LQDOCP``, ``sqp_hela BFGS`` -- hqp/Hqp_Init.C:96-121).
Here the same architecture is a plain registry of factories keyed by
``(slot, name)``; names are kept identical to the reference for parity.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple


class ModuleRegistry:
    """Registry of named, exchangeable solver components."""

    def __init__(self):
        self._factories: Dict[Tuple[str, str], Callable[..., Any]] = {}

    def register(self, slot: str, name: str):
        """Decorator: register a factory under (slot, name).

        Example::

            @modules.register("sqp_solver", "Powell")
            class SqpPowell: ...
        """

        def deco(factory):
            key = (slot, name)
            self._factories[key] = factory
            return factory

        return deco

    def create(self, slot: str, name: str, *args, **kwargs):
        key = (slot, name)
        if key not in self._factories:
            known = ", ".join(sorted(n for s, n in self._factories if s == slot))
            raise KeyError(
                f"no module {name!r} registered for slot {slot!r} "
                f"(known: {known or 'none'})"
            )
        return self._factories[key](*args, **kwargs)

    def names(self, slot: str):
        return sorted(n for s, n in self._factories if s == slot)

    def has(self, slot: str, name: str) -> bool:
        return (slot, name) in self._factories


#: Global registry, analog of the reference's If_Class lists.
modules = ModuleRegistry()
