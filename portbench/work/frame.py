"""A whole frame's least time and its kernels', by configuration and
traffic: what the roofline and ``mfu`` readers divide by."""
from __future__ import annotations

import math

from ..reference.imdn import spec as imdn_spec
from . import counts


def out_hw(traffic: dict):
    """The output frame's (rows, columns)."""
    if traffic["kind"] == "warp":
        return tuple(traffic["out_hw"])
    h, w = traffic["frame_hw"]
    s = traffic["scale"]
    return math.ceil(h * s), math.ceil(w * s)


def kernel_least_s(cfg: dict, traffic: dict) -> dict:
    """{kernel: least seconds a frame} of the kernels the frame runs."""
    hw, ohw, c = tuple(traffic["frame_hw"]), out_hw(traffic), cfg["in_c"]
    out = {}
    if cfg["form"] == "lut":
        members = 4 * len(cfg["modes"])
        s1 = counts.k2(hw, c, 1, len(cfg["modes"]), members, cfg["table_rows"])
        s2 = counts.k2(hw, c, cfg["out_c"], 2 * len(cfg["modes2"]), members,
                       cfg["table_rows"])
        out["k2"] = counts.bound_s(*s1) + counts.bound_s(*s2)
    else:
        nbytes, macs = counts.imdn_towers([s for _, s in imdn_spec(cfg)], hw,
                                          c, cfg["out_c"])
        out["towers"] = counts.bound_s(nbytes, 2 * macs)
    if traffic["kind"] == "warp":
        out["k5"] = counts.bound_s(*counts.k5(hw, ohw, c, cfg["support"]))
    else:
        out["k1"] = counts.bound_s(*counts.k1(hw, ohw, c, cfg["support"],
                                              floats=cfg["form"] == "imdn"))
    return out


def frame_least_s(cfg: dict, traffic: dict) -> float:
    """The least seconds of one frame, whatever implements it: the IMDN
    form's towers' and resize's operations at the float32 peak; the LUT
    form's the largest of its operations' time and its bytes' (the frame
    in, the tables once, the frame and mask out)."""
    hw, ohw, c = tuple(traffic["frame_hw"]), out_hw(traffic), cfg["in_c"]
    warp = traffic["kind"] == "warp"
    if warp:
        _, ops, f64 = counts.k5(hw, ohw, c, cfg["support"])
    else:
        _, ops = counts.k1(hw, ohw, c, cfg["support"],
                           floats=cfg["form"] == "imdn")
        f64 = 0
    if cfg["form"] == "imdn":
        _, macs = counts.imdn_towers([s for _, s in imdn_spec(cfg)], hw, c,
                                     cfg["out_c"])
        return counts.bound_s(f32_ops=2 * macs + ops, f64_ops=f64)
    members = 4 * len(cfg["modes"])
    for oc, tables in ((1, len(cfg["modes"])), (cfg["out_c"],
                                                2 * len(cfg["modes2"]))):
        ops += counts.k2(hw, c, oc, tables, members, cfg["table_rows"])[1]
    tables = cfg["table_rows"] * (len(cfg["modes"])
                                  + 2 * len(cfg["modes2"]) * cfg["out_c"])
    nbytes = (c * hw[0] * hw[1] + tables + c * ohw[0] * ohw[1]
              + (ohw[0] * ohw[1] if warp else 0))
    return counts.bound_s(nbytes, ops, f64)
