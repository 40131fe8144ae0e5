"""The reference's reading of a configuration: its published flags parsed
onto the frozen Config (a flag either takes the value after it, typed as
its field's default, or is a switch), the file's ``set`` keys, the seed,
then the presets (``finalize``)."""

from __future__ import annotations

import dataclasses
from typing import Dict

from .frozen.config import Config, finalize


def reference_config(config: Dict, seed: int) -> Config:
    fields = {f.name: f.default for f in dataclasses.fields(Config)}
    kw: Dict = {}
    toks = list(config["flags"])
    i = 0
    while i < len(toks):
        tok = toks[i]
        if tok == "-O":
            kw["O"] = True
            i += 1
            continue
        name = tok[2:]
        default = fields[name]
        if isinstance(default, bool):
            kw[name] = True
            i += 1
        else:
            kw[name] = type(default)(toks[i + 1])
            i += 2
    for k, v in config.get("set", {}).items():
        kw[k] = type(fields[k])(v)
    kw["seed"] = int(seed)
    return finalize(Config(**kw))
