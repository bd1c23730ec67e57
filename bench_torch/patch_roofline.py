"""Operations and bytes of the Hartmann pass's work (Hartmann et al.,
"Learned Multi-Patch Similarity", ICCV 2017), counted from the network's
equations and the gather's definition, not from any kernel.

A quintuple is one (ray, plane) of a reference view: one patch of
``patch_shape`` (ph, pw, C) around the plane point's projection in each
of the V views. Its two parts:

- the net (``net_cost``): each branch conv (VALID, k x k, then a 2x2
  pool) on every view's patch, then the head's convs on the mean of the
  views; 2 x the multiply-accumulates of the convolutions (the
  activations, pools, mean and softmax are left out, as they are in the
  float32 peak's count). Bytes: the patches read and the score written.
- the gather (``gather_cost``): per (view, patch pixel) the int64 index,
  the C float32 texels read and the C float32 patch values written. No
  operations.

``pass_work`` counts both for a pass of a cell from its configuration and
traffic alone, so a run of a program without the pass's counters reads
the same work.
"""
from bench_torch import roofline


def net_flops(patch_shape, views, branch, head, pool=2):
    """2 x the multiply-accumulates of one quintuple's net. ``branch`` and
    ``head`` are [filters, kernel] of each conv, in order."""
    h, w, c = patch_shape
    flops = 0
    for filters, k in branch:
        h, w = h - k + 1, w - k + 1
        flops += 2 * views * h * w * filters * c * k * k
        h, w, c = h // pool, w // pool, filters
    for filters, k in head:
        h, w = h - k + 1, w - k + 1
        flops += 2 * h * w * filters * c * k * k
        c = filters
    return flops


def net_cost(quintuples, patch_shape, views, net):
    """The net over ``quintuples``; ``net`` the configuration's "net"
    ({"branch", "head", "pool"})."""
    ph, pw, c = patch_shape
    ops = net_flops(patch_shape, views, net["branch"], net["head"],
                    net["pool"])
    return roofline.Cost(quintuples * (views * ph * pw * c * 4 + 4),
                         quintuples * ops)


def gather_cost(quintuples, patch_shape, views):
    """The patch gather of ``quintuples``: indices, texels read, patches
    written."""
    ph, pw, c = patch_shape
    return roofline.Cost(quintuples * views * ph * pw * (8 + 2 * c * 4), 0)


def pass_work(config, traffic):
    """{"quintuples", "net", "gather"} of one pass of a cell: H x W x D
    quintuples a reference view, and the costs of their net and gather."""
    refs = len(range(*traffic["images_range"]))
    quintuples = refs * traffic["height"] * traffic["width"] \
        * config["depth_planes"]
    shape, views = config["patch_shape"], config["neighbors"] + 1
    return {"quintuples": quintuples,
            "net": net_cost(quintuples, shape, views, config["net"]),
            "gather": gather_cost(quintuples, shape, views)}
