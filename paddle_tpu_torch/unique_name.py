"""fluid.unique_name (counterpart of paddle_tpu/unique_name.py): generate,
guard and switch over the name counters of core/framework.py."""

from __future__ import annotations

from .core.framework import _UniqueNameGenerator as UniqueNameGenerator  # noqa: F401
from .core.framework import unique_name as generate  # noqa: F401
from .core.framework import unique_name_guard as guard  # noqa: F401
from .core.framework import unique_name_switch as switch  # noqa: F401

__all__ = ["generate", "guard", "switch", "UniqueNameGenerator"]
