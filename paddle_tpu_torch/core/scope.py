"""Scope: runtime name -> value map (counterpart of
paddle_tpu/core/scope.py).

Values are torch tensors on the device of the executor that wrote them.
``set_var`` also takes a numpy array, as the JAX scope does; an executor
moves it onto its device when a program reads it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

__all__ = ["Scope", "global_scope"]


class Scope:
    def __init__(self):
        self._vars: Dict[str, Any] = {}

    def find_var(self, name: str) -> Optional[Any]:
        return self._vars.get(name)

    def set_var(self, name: str, value: Any) -> None:
        self._vars[name] = value


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope
