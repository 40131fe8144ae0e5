"""The port's command line against configs/: every shipped ``python
main.py ...`` line of ``configs/**/*.txt`` parses through
``mirres_restir_nerf_mesh_torch.main.config_from_args`` into a ``Config``
equal, field by field, to the root ``main.config_from_args``'s (the JAX
package's CLI).  One case a line, as tests/test_configs.py."""

from __future__ import annotations

import dataclasses
import glob
import os
import shlex

import pytest
import torch

from test_torch_helpers import TORCH_THREADS

torch.set_num_threads(TORCH_THREADS)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _command_lines():
    out = []
    for path in sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.txt"), recursive=True)):
        for line in open(path):
            line = line.strip()
            if line.startswith("python main.py"):
                rel = os.path.relpath(path, REPO)
                out.append(pytest.param(shlex.split(line)[2:], id=f"{rel}:{line[:60]}"))
    return out


@pytest.mark.parametrize("argv", _command_lines())
def test_port_config_equals_reference(argv):
    from main import config_from_args as j_config
    from mirres_restir_nerf_mesh_torch.main import config_from_args as t_config

    ref, got = j_config(argv), t_config(argv)
    ref_f = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    got_f = {f.name: getattr(got, f.name) for f in dataclasses.fields(got)}
    assert sorted(got_f) == sorted(ref_f)
    assert {k: v for k, v in got_f.items() if ref_f[k] != v} == {}


def test_every_shipped_line_is_a_case():
    assert len(_command_lines()) >= 70
