"""Declarative protection plans: which ops are protected, how, with what
policy and thresholds.

A :class:`ProtectionPlan` is an ordered tuple of :class:`OpRule` patterns.
Every protected call site is addressed as ``"<op_kind>/<path>"`` — e.g.
``qgemm/attn.wq``, ``embedding_bag/tables``, ``kv_cache/attn`` — and a rule
pattern is an ``fnmatch`` glob over that string (a pattern without ``/``
also matches the bare op kind, so ``qgemm`` covers every int8 GEMM).
Rules are applied in order, later rules overriding earlier ones
field-by-field; unset (``None``) fields inherit.  Resolution produces a
:class:`ResolvedRule` with concrete defaults.

Plans are frozen (hashable — they ride inside the jit-static layer ``Ctx``),
serialize to/from dicts for configs, and parse from compact CLI strings::

    *:policy=log                          # protect everything, log-only
    embedding_bag:off                     # ...but EB protection disabled
    qgemm:policy=recompute:retries=2      # int8 GEMMs retry on detection
    qgemm/attn.*:scheme=unfused           # attention projections, BLAS-2
    embedding_bag:rel_bound=1e-4          # looser Eq. (5) threshold

joined with commas:
``"*:policy=log,embedding_bag:off,qgemm/attn.*:scheme=unfused"``.
"""
from __future__ import annotations

import dataclasses
import fnmatch
from typing import Optional, Tuple

#: the detect->act policies repro_torch.core.policy implements.
POLICY_NAMES = ("log", "recompute", "correct", "abort")

#: how a float-checked op's ``rel_bound`` is chosen: ``static`` (the
#: rule's/op's constant — the default) or ``adaptive`` (an online
#: FP-budget controller owns it and rewrites the bound at evaluation
#: ticks; that controller is not ported yet).  The field is pure metadata to the
#: resolver — the adapt layer reads it to decide which ops it manages.
THRESHOLD_MODES = ("static", "adaptive")

#: op kinds that default to DISABLED unless a matching rule enables them:
#: the quantized KV cache changes the cache representation (lossy int8),
#: and float-GEMM ABFT adds training-path work — both are opt-in, so a
#: plan like ``"*:policy=recompute"`` tunes the paper's serving operators
#: without silently switching these on.  An explicit ``kv_cache:on`` (or a
#: wildcard rule carrying ``on``/``off``) overrides.  The paged cache
#: (``kv_cache_paged``) follows the same opt-in contract as the
#: contiguous one — same representation change, same policy surface.
OPT_IN_OPS = ("float_gemm", "kv_cache", "kv_cache_paged")


@dataclasses.dataclass(frozen=True)
class OpRule:
    """One pattern's (partial) protection settings. ``None`` = inherit."""
    pattern: str = "*"
    enabled: Optional[bool] = None
    scheme: Optional[str] = None          # adapter-specific (e.g. qgemm:
    policy: Optional[str] = None          #   packed | unfused | pallas)
    rel_bound: Optional[float] = None     # float-checked ops' threshold
    max_retries: Optional[int] = None     # recompute policy budget
    threshold: Optional[str] = None       # static | adaptive (None=inherit)

    def __post_init__(self):
        if self.policy is not None and self.policy not in POLICY_NAMES:
            raise ValueError(f"unknown policy {self.policy!r}; "
                             f"have {POLICY_NAMES}")
        if self.max_retries is not None and self.max_retries < 1:
            raise ValueError("max_retries must be >= 1")
        if self.threshold is not None and \
                self.threshold not in THRESHOLD_MODES:
            raise ValueError(f"unknown threshold mode {self.threshold!r}; "
                             f"have {THRESHOLD_MODES}")

    def matches(self, op: str, path: str = "") -> bool:
        target = f"{op}/{path}"
        return (fnmatch.fnmatchcase(target, self.pattern)
                or fnmatch.fnmatchcase(op, self.pattern))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ResolvedRule:
    """A fully-resolved rule for one call site (all defaults applied)."""
    enabled: bool = True
    scheme: Optional[str] = None          # None = adapter default
    policy: str = "log"
    rel_bound: Optional[float] = None     # None = op default
    max_retries: int = 1
    threshold: str = "static"


@dataclasses.dataclass(frozen=True)
class ProtectionPlan:
    """Ordered protection rules over every ABFT-protected operator."""
    rules: Tuple[OpRule, ...] = ()
    name: str = ""

    def __post_init__(self):
        if not isinstance(self.rules, tuple):
            object.__setattr__(self, "rules", tuple(self.rules))

    # ------------------------------ resolve ---------------------------------

    def resolve(self, op: str, path: str = "") -> ResolvedRule:
        enabled = op not in OPT_IN_OPS
        scheme, policy = None, None
        rel_bound, max_retries = None, None
        threshold = None
        for r in self.rules:
            if not r.matches(op, path):
                continue
            if r.enabled is not None:
                enabled = r.enabled
            if r.scheme is not None:
                scheme = r.scheme
            if r.policy is not None:
                policy = r.policy
            if r.rel_bound is not None:
                rel_bound = r.rel_bound
            if r.max_retries is not None:
                max_retries = r.max_retries
            if r.threshold is not None:
                threshold = r.threshold
        return ResolvedRule(enabled=enabled, scheme=scheme,
                            policy=policy or "log", rel_bound=rel_bound,
                            max_retries=max_retries or 1,
                            threshold=threshold or "static")

    def with_rules(self, *rules: OpRule) -> "ProtectionPlan":
        """A new plan with ``rules`` appended (they override)."""
        return dataclasses.replace(self, rules=self.rules + tuple(rules))

    def escalated(self) -> "ProtectionPlan":
        """The detect→act escalation of this plan: every ``log`` policy
        upgraded to ``recompute`` (and a leading wildcard recompute rule
        so un-policied sites stop at log no longer).  Enablement is left
        untouched — no op switches on or off, so the escalated plan runs
        against the same compiled cache/batch structure; the serving
        engine applies it when the health monitor degrades a lane."""
        rules = tuple(
            dataclasses.replace(r, policy="recompute")
            if r.policy == "log" else r
            for r in self.rules)
        return dataclasses.replace(
            self, rules=(OpRule("*", policy="recompute"),) + rules,
            name=f"{self.name}+escalated" if self.name else "escalated")

    # ------------------------------ serde -----------------------------------

    @classmethod
    def parse(cls, text: str, name: str = "") -> "ProtectionPlan":
        """Parse the compact CLI form (see module docstring)."""
        rules = []
        for clause in (text or "").split(","):
            clause = clause.strip()
            if not clause:
                continue
            parts = clause.split(":")
            head, settings = parts[0], parts[1:]
            if head in ("on", "off") and not settings:
                # bare on/off applies to everything
                head, settings = "*", [head]
            kw = {}
            for s in settings:
                s = s.strip()
                if s == "on":
                    kw["enabled"] = True
                elif s == "off":
                    kw["enabled"] = False
                elif "=" in s:
                    k, v = s.split("=", 1)
                    k = k.strip()
                    if k == "policy":
                        kw["policy"] = v.strip()
                    elif k == "scheme":
                        kw["scheme"] = v.strip()
                    elif k == "rel_bound":
                        kw["rel_bound"] = float(v)
                    elif k in ("retries", "max_retries"):
                        kw["max_retries"] = int(v)
                    elif k == "threshold":
                        kw["threshold"] = v.strip()
                    else:
                        raise ValueError(f"unknown plan setting {k!r} in "
                                         f"clause {clause!r}")
                else:
                    raise ValueError(f"bad plan clause {clause!r}: "
                                     f"setting {s!r} is not on/off/key=val")
            rules.append(OpRule(pattern=head, **kw))
        return cls(rules=tuple(rules), name=name or text)

    def to_dict(self) -> dict:
        return {"name": self.name,
                "rules": [r.to_dict() for r in self.rules]}

    @classmethod
    def from_dict(cls, d: dict) -> "ProtectionPlan":
        return cls(rules=tuple(OpRule(**r) for r in d.get("rules", ())),
                   name=d.get("name", ""))

    @classmethod
    def from_any(cls, spec, name: str = "") -> "ProtectionPlan":
        """Resolve a plan from whatever a config hands us.

        * a :class:`ProtectionPlan` passes through;
        * a dict goes through :meth:`from_dict` (a bare list is treated
          as the ``rules`` entry);
        * a string starting with ``@`` names a JSON file holding any of
          the above (or a compact plan string);
        * any other string is the compact CLI form (:meth:`parse`).
        """
        if isinstance(spec, ProtectionPlan):
            return spec
        if isinstance(spec, dict):
            return cls.from_dict(spec)
        if isinstance(spec, (list, tuple)):
            return cls.from_dict({"rules": list(spec), "name": name})
        if isinstance(spec, str):
            s = spec.strip()
            if s.startswith("@"):
                import json
                import os
                path = s[1:]
                with open(path) as f:
                    loaded = json.load(f)
                base = os.path.splitext(os.path.basename(path))[0]
                return cls.from_any(loaded, name=name or base)
            return cls.parse(s, name=name)
        raise TypeError(f"cannot build a ProtectionPlan from "
                        f"{type(spec).__name__}")

    def describe(self) -> str:
        if not self.rules:
            return "<all ops protected, policy=log>"
        out = []
        for r in self.rules:
            bits = [r.pattern]
            if r.enabled is not None:
                bits.append("on" if r.enabled else "off")
            if r.policy is not None:
                bits.append(f"policy={r.policy}")
            if r.scheme is not None:
                bits.append(f"scheme={r.scheme}")
            if r.rel_bound is not None:
                bits.append(f"rel_bound={r.rel_bound:g}")
            if r.max_retries is not None:
                bits.append(f"retries={r.max_retries}")
            if r.threshold is not None:
                bits.append(f"threshold={r.threshold}")
            out.append(":".join(bits))
        return ",".join(out)


def default_plan() -> ProtectionPlan:
    """Serving default: the paper's two operators protected with policy
    ``log``; the :data:`OPT_IN_OPS` (float GEMM, KV cache) stay off until
    a rule enables them — byte-for-byte the behavior of the legacy
    ``Ctx(abft=True)`` flags."""
    return ProtectionPlan(rules=(OpRule("*", policy="log"),),
                          name="default")


def unprotected_plan() -> ProtectionPlan:
    """Everything off — the overhead-comparison baseline."""
    return ProtectionPlan(rules=(OpRule("*", enabled=False),),
                          name="unprotected")
