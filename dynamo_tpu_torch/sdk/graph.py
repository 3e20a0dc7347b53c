"""Graph discovery + link composition.  A copy of the JAX package's
``sdk/graph.py``.

Reference semantics: deploy/dynamo/sdk lib/service.py:36-56 (LinkedServices)
and the ``Graph.link()`` pattern in examples/llm/graphs/*.py — an entry
service plus its transitive ``depends()`` closure forms the deployable
graph; ``link`` can add edges dynamically (e.g. choosing which worker
implementation backs a processor at deploy time).
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Set, Tuple, Type

from .service import Dependency, ServiceMeta, collect_dependencies


class Graph:
    """An entry service + extra linked edges."""

    def __init__(self, entry: Type):
        assert hasattr(entry, "_dynamo_meta"), f"{entry} is not a @service"
        self.entry = entry
        self._extra_edges: List[Tuple[Type, Type]] = []

    def link(self, frm: Type, to: Type, endpoint: str | None = None) -> "Graph":
        """Add a depends edge frm → to at graph-composition time."""
        dep = Dependency(to, endpoint)
        # Attach as a class attribute so workers resolve it like static deps.
        attr = f"_linked_{to.__name__.lower()}"
        setattr(frm, attr, dep)
        self._extra_edges.append((frm, to))
        return self

    def services(self) -> List[Type]:
        return discover_services(self.entry)


def discover_services(entry: Type) -> List[Type]:
    """Transitive closure over depends() edges, entry first, deterministic."""
    seen: Set[Type] = set()
    order: List[Type] = []

    def visit(cls: Type) -> None:
        if cls in seen:
            return
        seen.add(cls)
        order.append(cls)
        for dep in collect_dependencies(cls).values():
            visit(dep.target)
        # linked edges attached by Graph.link
        for name, member in vars(cls).items():
            if name.startswith("_linked_") and isinstance(member, Dependency):
                visit(member.target)

    visit(entry)
    return order


def load_target(spec: str) -> Type:
    """Resolve ``pkg.module:ClassName`` to the service class."""
    module_name, _, attr = spec.partition(":")
    if not attr:
        raise ValueError(f"graph target must be module:Class, got {spec!r}")
    module = importlib.import_module(module_name)
    target = getattr(module, attr)
    if isinstance(target, Graph):
        return target.entry
    return target
