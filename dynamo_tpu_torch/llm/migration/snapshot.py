"""SequenceSnapshot (a copy of the JAX package's llm/migration/snapshot.py,
key for key the same wire dict): the serializable decode-state checkpoint of a live
sequence — everything besides the KV pages needed to continue the stream
token-identically on another worker.

The KV pages travel separately over the hash-addressed transfer plane
(engine/transfer.py export/inject); the snapshot is the small control-plane
record: fed tokens, resolved sampler state (seed + rng-stream position via
``orig_prompt_len``), stop conditions, speculative-decoding controller
state, the request's remaining deadline, and — when a detokenizing edge
migrates its own state rather than keeping the stream spliced below it —
the incremental-detok/stop-jail state (llm/backend.py ``Decoder.state_dict``).

``to_resume_request()`` turns a snapshot into an ordinary
PreprocessedRequest wire dict: the target engine needs NO special admission
path — the folded prompt admits against the transferred blocks as a prefix
hit, and the ``resume`` annotation restores the rng-stream position so the
continued sample stream is byte-identical to the never-migrated run (the
engine's seeded sampler keys on (seed, output-index), both preserved).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

SNAPSHOT_VERSION = 1


@dataclass
class SequenceSnapshot:
    request_id: str
    # Full fed-token stream at snapshot time: original prompt + every
    # generated token (the hash-addressed identity KV blocks seal under).
    token_ids: List[int]
    # Length of the ORIGINAL prompt: generated-token accounting (sampler
    # rng steps, max/min_tokens, usage, penalties) counts from here.
    orig_prompt_len: int
    # Resolved sampling state (engine defaults applied — notably the seed,
    # so resume does not depend on the target engine's own seed).
    sampling: Dict[str, Any] = field(default_factory=dict)
    # Stop conditions as the source engine held them.
    stop: Dict[str, Any] = field(default_factory=dict)
    # Speculative-decoding controller state (engine/spec.py): acceptance
    # history is a property of the traffic and travels with the sequence.
    spec: Dict[str, Any] = field(default_factory=dict)
    # Remaining wall-clock budget at snapshot time (informational: the
    # routed client's own Deadline stays authoritative across the splice).
    deadline_s: Optional[float] = None
    # Incremental detokenizer + stop-string jail state (llm/backend.py).
    # None when the edge keeps its Decoder alive across the splice (the
    # normal routed-client path — token ids below the Backend operator are
    # what migrate, so edge detok state never moves).
    detok: Optional[Dict[str, Any]] = None
    # Tenant identity (llm/tenancy): the LoRA adapter serving this
    # sequence and the KV salt its blocks seal under — the target must
    # resume under the SAME adapter (correct forward) and salt
    # (addressable KV), or the stream silently changes tenants.
    adapter: Optional[str] = None
    kv_salt: Optional[str] = None
    # QoS identity (llm/qos.py): the fairness tenant and priority class the
    # source scheduled under — the target must resume in the SAME class
    # and fairness flow, or a migration would silently launder a batch row
    # into the protected interactive band (and vice versa).
    tenant: Optional[str] = None
    priority: Optional[str] = None
    # Structured-output constraint: the serialized TokenMaskAutomaton.
    # The automaton STATE does not travel — the target re-derives it by
    # advancing from the start state through the resumed output tokens
    # (every delivered token was mask-admissible, so the walk cannot
    # fail on an honest snapshot).
    grammar: Optional[Dict[str, Any]] = None
    # Distributed-tracing context (runtime/tracing.py TraceContext wire
    # dict): a migrated stream must stay ONE trace, so the target resumes
    # recording spans under the SAME trace_id the source served.  Omitted
    # for untraced sequences (the overwhelmingly common case).
    trace: Optional[Dict[str, Any]] = None
    version: int = SNAPSHOT_VERSION

    @property
    def emitted(self) -> int:
        """Generated tokens already delivered to the stream."""
        return len(self.token_ids) - self.orig_prompt_len

    def to_dict(self) -> Dict[str, Any]:
        # Optional fields ship omit-when-absent (from_dict tolerates the
        # missing keys): base traffic's snapshots keep the pre-tenancy wire
        # shape, and consumers that predate a field never see it — the
        # same wire-compat contract as PreprocessedRequest.grammar
        # (dynalint DYN302 enforces it for every new optional field).
        out = {
            "version": self.version,
            "request_id": self.request_id,
            "token_ids": list(self.token_ids),
            "orig_prompt_len": self.orig_prompt_len,
            "sampling": dict(self.sampling),
            "stop": dict(self.stop),
            "spec": dict(self.spec),
        }
        if self.deadline_s is not None:
            out["deadline_s"] = self.deadline_s
        if self.detok is not None:
            out["detok"] = self.detok
        if self.adapter is not None:
            out["adapter"] = self.adapter
        if self.kv_salt is not None:
            out["kv_salt"] = self.kv_salt
        if self.tenant is not None:
            out["tenant"] = self.tenant
        if self.priority is not None:
            out["priority"] = self.priority
        if self.grammar is not None:
            out["grammar"] = self.grammar
        if self.trace is not None:
            out["trace"] = self.trace
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SequenceSnapshot":
        return cls(
            request_id=d["request_id"],
            token_ids=list(d["token_ids"]),
            orig_prompt_len=int(d["orig_prompt_len"]),
            sampling=dict(d.get("sampling") or {}),
            stop=dict(d.get("stop") or {}),
            spec=dict(d.get("spec") or {}),
            deadline_s=d.get("deadline_s"),
            detok=d.get("detok"),
            adapter=d.get("adapter"),
            kv_salt=d.get("kv_salt"),
            tenant=d.get("tenant"),
            priority=d.get("priority"),
            grammar=d.get("grammar"),
            trace=d.get("trace"),
            version=int(d.get("version", SNAPSHOT_VERSION)),
        )

    def to_resume_request(self) -> Dict[str, Any]:
        """PreprocessedRequest wire dict that continues this stream.

        Dispatched by the routed client after the ``migrated`` splice (or
        rebuilt client-side for seeded crash recovery); the target engine's
        ``SequenceState.from_request`` honours the ``resume`` annotation.
        """
        samp = self.sampling
        return {
            "token_ids": list(self.token_ids),
            "sampling_options": {
                "temperature": samp.get("temperature"),
                "top_p": samp.get("top_p"),
                "top_k": samp.get("top_k"),
                "frequency_penalty": samp.get("frequency_penalty"),
                "presence_penalty": samp.get("presence_penalty"),
                # The RESOLVED seed: exact-stream resume must not depend on
                # the target re-deriving an engine-default seed.
                "seed": samp.get("seed"),
                "logprobs": samp.get("logprobs"),
                "spec_decode": samp.get("spec_decode"),
            },
            "stop_conditions": {
                "max_tokens": self.stop.get("max_tokens"),
                "min_tokens": self.stop.get("min_tokens"),
                "stop_token_ids": list(self.stop.get("stop_token_ids") or []),
                "ignore_eos": bool(self.stop.get("ignore_eos", False)),
            },
            "model": None,
            "annotations": {
                "resume": {
                    "orig_prompt_len": self.orig_prompt_len,
                    "spec": dict(self.spec),
                },
                # Tenant identity (llm/tenancy): adapter + salt resume on
                # the target exactly as the source served them.  Keys are
                # omitted for base traffic so pre-tenancy consumers see
                # the old annotation shape.
                **({"adapter": self.adapter} if self.adapter else {}),
                **({"kv_salt": self.kv_salt} if self.kv_salt else {}),
                # QoS fairness flow (llm/qos.py; omitted when default).
                **({"tenant": self.tenant} if self.tenant else {}),
                # Tracing continuity (runtime/tracing.py): the target's
                # engine parses annotations.trace, so the resumed stream's
                # spans join the original trace.
                **({"trace": dict(self.trace)} if self.trace else {}),
            },
            **({"grammar": dict(self.grammar)} if self.grammar else {}),
            **({"priority": self.priority} if self.priority else {}),
        }
