"""Counters the benchmark records around calls into the program during the
traced window. A metric reader names public functions of the program
(`HOOKS`: (module, function) pairs), how to count one call (`count(args,
kwargs, function name)`, a dict of numbers) and the program's own counter
of the calls that launched its kernels (`COUNTER`: (module, attribute)). The harness
wraps each function for the window and sums the dicts; the counter's rise
over the window is kept beside them as `launches`.

A function is wrapped in place (its code object is swapped for one that
counts and calls the original), so every reference to it counts: a module
attribute, an import into another module, or a default argument bound when
the program was imported. A hook that cannot be installed raises: a reader
never loses its yardstick in silence."""

from __future__ import annotations

import importlib
import types
from collections import defaultdict


class HookError(RuntimeError):
    pass


def _target(module: str, attr: str):
    try:
        mod = importlib.import_module(module)
    except ImportError as e:
        raise HookError(f"cannot hook {module}.{attr}: {e}") from e
    fn = getattr(mod, attr, None)
    if not isinstance(fn, types.FunctionType) or fn.__closure__:
        raise HookError(f"cannot hook {module}.{attr}: not a module-level Python function")
    return fn


class Hooks:
    def __init__(self):
        self.sums = defaultdict(lambda: defaultdict(float))
        self._undo = []
        self._counters = []

    def install(self, name: str, hooks, count, counter=None):
        """Wrap every (module, function) of `hooks`, summing count(args,
        kwargs, function name) under `name`; with `counter` (module,
        attribute), also keep its rise until `remove` as
        sums[name]["launches"]."""
        sums = self.sums[name]
        for module, attr in hooks:
            fn = _target(module, attr)
            inner = types.FunctionType(fn.__code__, fn.__globals__, fn.__name__,
                                       fn.__defaults__)
            inner.__kwdefaults__ = fn.__kwdefaults__
            slot = f"__hbench_{name}_{attr}".replace(".", "_")

            def call(args, kwargs, _inner=inner, _attr=attr):
                for k, v in count(args, kwargs, _attr).items():
                    sums[k] += v
                return _inner(*args, **kwargs)

            ns = {}
            exec(f"def {attr}(*args, **kwargs):\n    return {slot}(args, kwargs)\n", {}, ns)
            fn.__globals__[slot] = call
            self._undo.append((fn, fn.__code__, slot))
            fn.__code__ = ns[attr].__code__
        if counter is not None:
            mod = importlib.import_module(counter[0])
            if not isinstance(getattr(mod, counter[1], None), int):
                raise HookError(f"{counter[0]}.{counter[1]} is not a counter")
            sums["launches"] += 0.0
            self._counters.append((name, mod, counter[1], getattr(mod, counter[1])))

    def remove(self):
        for name, mod, attr, start in self._counters:
            self.sums[name]["launches"] += getattr(mod, attr) - start
        self._counters.clear()
        for fn, code, slot in reversed(self._undo):
            fn.__code__ = code
            fn.__globals__.pop(slot, None)
        self._undo.clear()
