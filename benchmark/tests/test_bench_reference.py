"""The plain references against the port at a tiny size on the CPU: the
same parameter names and shapes, and in float32 the same losses, updates,
features, scores and graphs to float32 rounding."""

import pytest
import torch

from benchmark import harness
from benchmark.reference import detr, relation
from benchmark.tests import tiny


@pytest.mark.parametrize("name", ["vg-hiercom", "oiv6-hiercom"])
def test_head_parameters_are_the_ports(name):
    from scene_graph_commonsense_torch.models.relation_head import (
        module_from_cfg)
    conf = tiny.conf(name)
    with torch.device("meta"):
        sd = module_from_cfg(harness.port_config(conf, 4, 0)).state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} \
        == relation.param_shapes(conf)


def test_featurizer_parameters_are_the_ports():
    from scene_graph_commonsense_torch.models.detr import module_from_cfg
    conf = tiny.conf("vg-hiercom", serve=True)
    with torch.device("meta"):
        sd = module_from_cfg(harness.port_config(conf, 3, 0)).state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} \
        == detr.param_shapes(conf)


@pytest.mark.parametrize("cell", ["vg-hiercom.train", "vg-hiercom.serve-max"])
def test_reference_follows_the_float32_port(cell):
    numbers = tiny.run(cell, dtype="float32")["numbers"]
    assert numbers and max(numbers.values()) < 1e-4, numbers
