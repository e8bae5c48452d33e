"""The port's configuration fields that the JAX package's configs lack,
for tests that hold a port config against its JAX twin field by field."""

from __future__ import annotations

import dataclasses

from repro.configs.base import ArchConfig as JaxArchConfig
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro_torch.configs.base import ArchConfig, MoEConfig


def _port_only_defaults(port_cls, jax_cls) -> dict:
    """{name: default} of ``port_cls``'s fields that ``jax_cls`` lacks."""
    theirs = {f.name for f in dataclasses.fields(jax_cls)}
    return {f.name: f.default for f in dataclasses.fields(port_cls)
            if f.name not in theirs}


def with_port_only_fields(ref: dict) -> dict:
    """A JAX config's ``dataclasses.asdict`` with the port-only fields added
    at their defaults: what the port's twin of that config gives."""
    out = {**ref, **_port_only_defaults(ArchConfig, JaxArchConfig)}
    if out.get("moe") is not None:
        out["moe"] = {**out["moe"], **_port_only_defaults(MoEConfig, JaxMoEConfig)}
    return out
