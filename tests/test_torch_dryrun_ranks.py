"""The rank function ``tests/test_torch_dryrun.py`` spawns (no JAX here,
so spawned ranks import this module quickly): each reduced cell's train,
prefill and decode step (``launch.dryrun.lower_cell``) on a real gloo
rank, in fp32 on the CPU, with its collectives by kind, and the matmul
FLOPs ``torch.utils.flop_counter.FlopCounterMode`` counts of its prefill
and its decode on dense weights beside ``obs.costs.contiguous_work``'s.
"""
import dataclasses

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ShapeSuite, reduced_config
from repro_torch.launch.dryrun import lower_cell

# (name, arch): a dense, an MoE and an SSM stack
STACKS = [("dense", "stablelm-1.6b"), ("moe", "dbrx-132b"),
          ("ssm", "mamba2-370m")]
SUITES = [ShapeSuite("train_t", "train", 8, 4),
          ShapeSuite("prefill_t", "prefill", 8, 4),
          ShapeSuite("decode_t", "decode", 8, 4)]
# a batch of 3 does not divide the dp axis: every rank runs every row, so
# an MoE block's capacity is the call's own (with rows split, a rank runs
# its kept rows of the global capacity, which the routing decides)
FLOP_SUITES = [ShapeSuite("prefill_t3", "prefill", 8, 3),
               ShapeSuite("decode_t3", "decode", 8, 3)]
DTYPE = torch.float32


def stack_cfg(name: str):
    arch = dict(STACKS)[name]
    return dataclasses.replace(reduced_config(arch), capacity_factor=16.0)


def cell(mesh, name: str, suite, device: str, serve_weights="qtensor"):
    return lower_cell(dict(STACKS)[name], suite.name, multi_pod=False,
                      serve_weights=serve_weights, mesh=mesh,
                      cfg=stack_cfg(name), suite=suite, device=device,
                      dtype=DTYPE)


def tally_job(mesh, names):
    """On this rank: each stack's cells' collectives, and the FLOPs of its
    prefill and decode on dense weights, counted and by FlopCounterMode."""
    out = {"rank": mesh.rank, "cells": {}, "flops": {}}
    for name in names:
        for suite in SUITES:
            res = cell(mesh, name, suite, "cpu")
            out["cells"][(name, suite.name)] = res["collectives"]
        for suite in FLOP_SUITES:
            with FlopCounterMode(display=False) as fc:
                res = cell(mesh, name, suite, "cpu", serve_weights="fp16")
            out["flops"][(name, suite.name)] = (
                fc.get_total_flops(), res["work"]["matmul_flops"])
    return out
