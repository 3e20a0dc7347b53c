"""Pipeline graph: operators with forward (request) and backward (response) edges.

Copy of the JAX package's ``runtime/pipeline.py``.  Reference semantics:
lib/runtime/src/pipeline/nodes.rs:16-210 — a pipeline is a chain
``frontend → op₁ → … → opₙ → backend(engine)`` where each operator
transforms the request on the way down (forward edge) and the response
stream on the way back up (backward edge).  One operator object owns both
directions so paired state (e.g. a tokenizer used to encode the prompt and
incrementally decode the output) lives in one place.

Python design: rather than the reference's explicit dual-edge node graph we use
structured composition — an ``Operator`` receives the request and the *next*
engine and returns the transformed stream.  This keeps the same power
(operators can short-circuit, fan out, or annotate both directions) with far
less machinery, and composes into a single ``AsyncEngine`` so a pipeline can
itself be served as an endpoint.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Generic, Sequence, TypeVar

from .engine import AsyncEngine, Context, ResponseStream

ReqIn = TypeVar("ReqIn")
ReqOut = TypeVar("ReqOut")
RespIn = TypeVar("RespIn")
RespOut = TypeVar("RespOut")


class Operator(ABC, Generic[ReqIn, ReqOut, RespIn, RespOut]):
    """A bidirectional pipeline stage.

    ``generate`` receives the inbound request and the downstream engine; it
    transforms the request, calls ``next``, and transforms the returned stream.
    Equivalent of the reference's ``PipelineOperator`` with
    ``forward_edge()``/``backward_edge()`` (pipeline/nodes.rs:122-210).
    """

    @abstractmethod
    async def generate(
        self,
        request: Context[ReqIn],
        next: AsyncEngine[ReqOut, RespIn],
    ) -> ResponseStream[RespOut]:
        ...

    def chain(self, next: AsyncEngine[ReqOut, RespIn]) -> AsyncEngine[ReqIn, RespOut]:
        """Bind this operator in front of an engine, yielding a new engine."""
        op = self

        class _Chained(AsyncEngine):
            async def generate(self, request: Context) -> ResponseStream:
                return await op.generate(request, next)

        return _Chained()


def build_pipeline(
    operators: Sequence[Operator],
    engine: AsyncEngine,
) -> AsyncEngine:
    """Compose ``operators`` (outermost first) in front of ``engine``.

    ``build_pipeline([preprocessor, backend], torch_engine)`` is the
    reference's ``frontend.link(preprocessor.forward_edge()).link(backend
    .forward_edge()).link(ServiceBackend::from_engine(engine)).link(backend
    .backward_edge()).link(preprocessor.backward_edge()).link(frontend)``
    (launch/dynamo-run/src/input/http.rs:92-111) — collapsed: composition
    nests the backward edges automatically.
    """
    composed = engine
    for op in reversed(list(operators)):
        composed = op.chain(composed)
    return composed

