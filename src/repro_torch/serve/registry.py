"""Method registry: names -> servable methods, launchers -> ids.

The registry is the only place the sweep service learns what it can
serve: ``SweepService`` takes one at construction (by default
:func:`default_registry`) and routes every ``submit(name, ...)``
through it.  Each distinct launcher instance gets a small integer id in
registration order (sweep = 0, int8cr = 1, quality = 2 in the default
registry), which a multi-process service will carry in its launch
headers.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.serve.method import (AdviseMethod, BestCompressorMethod,
                                      FeaturizeMethod, FindEbMethod,
                                      FindSettingMethod, KVGateMethod,
                                      Launcher, QualityMethod, ServableMethod,
                                      SweepLauncher)


class MethodRegistry:
    """Name -> :class:`ServableMethod` map plus the launcher id space."""

    def __init__(self):
        self._methods: Dict[str, ServableMethod] = {}
        self._launchers: List[Launcher] = []

    def register(self, method: ServableMethod) -> ServableMethod:
        if not method.name:
            raise ValueError("servable method needs a non-empty name")
        if method.name in self._methods:
            raise ValueError(
                f"method {method.name!r} is already registered")
        if method.launcher not in self._launchers:
            self._launchers.append(method.launcher)
        self._methods[method.name] = method
        return method

    def get(self, name: str) -> ServableMethod:
        try:
            return self._methods[name]
        except KeyError:
            raise ValueError(
                f"unknown servable method {name!r}; registered: "
                f"{sorted(self._methods)}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._methods

    def methods(self) -> Tuple[ServableMethod, ...]:
        return tuple(self._methods.values())

    def names(self) -> Tuple[str, ...]:
        return tuple(self._methods)

    def launcher_id(self, launcher: Launcher) -> int:
        return self._launchers.index(launcher)

    def launcher(self, gid: int) -> Launcher:
        return self._launchers[int(gid)]


def default_registry() -> MethodRegistry:
    """The built-in methods, in the reference's order: featurize,
    find_eb (UC1) and best_compressor (UC2) on one shared sweep launcher,
    the int8 KV gate, the advisor and find_setting (UC3) on the sweep
    launcher again, and quality on its own launcher.  A fresh instance
    per call: services never share mutable registry state."""
    reg = MethodRegistry()
    sweep = SweepLauncher()
    reg.register(FeaturizeMethod(sweep))
    reg.register(FindEbMethod(sweep))
    reg.register(BestCompressorMethod(sweep))
    reg.register(KVGateMethod())
    reg.register(AdviseMethod(sweep))
    reg.register(FindSettingMethod(sweep))
    reg.register(QualityMethod())
    return reg
