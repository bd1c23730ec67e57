"""Operations and bytes of the CasMVSNet pass's work (Gu et al., CVPR
2020), counted from the network's equations and the cost volume's
definition, not from any kernel.

A pass featurises each image of its view sets once and, for each
reference view, runs three stages: a cost volume, its U-Net and the depth
regression. Its parts:

- the FPN (``fpn_cost``, counted by hand): 2 x the multiply-accumulates of
  the bottom-up convs (``mvs_roofline.stack_cost`` over ``feature_net``)
  and of the lateral and output convs (``fpn``, each at its map's
  resolution); the nearest upsampling and the sums are left out. Bytes:
  the image read, the three stages' maps written.
- K4 at each stage (``mvs_roofline.cost_volume_cost`` at the stage's maps,
  channels and hypotheses); a per-pixel stage also reads its (H, W)
  float32 centre depths.
- the U-Net at each stage (``mvs_roofline.stack_cost`` over the stage's
  ``cost_regularization``, 3D).

``pass_work`` counts a pass of a cell from its configuration, its traffic
and the scene's view sets alone, so a run of a program without the pass's
counters reads the same work.
"""
from bench_torch import roofline
from bench_torch.mvs_roofline import cost_volume_cost, stack_cost


def fpn_cost(config, crop_shape):
    """The FPN's Cost on one image of ``crop_shape`` (H, W)."""
    H, W = crop_shape
    bottom, _ = stack_cost(config["feature_net"], crop_shape, 2)
    macs, maps = bottom.ops // 2, 0
    for name, cin, cout, k, stride, _ in config["fpn"]:
        pixels = (H // stride) * (W // stride)
        macs += pixels * cin * cout * k * k
        if name.startswith("out"):  # a stage's map
            maps += cout * pixels
    return roofline.Cost(4 * (config["feature_net"][0][1] * H * W + maps),
                         2 * macs)


def stage_shapes(config, crop_shape):
    """[(channels, hypotheses, h, w)] of each stage's cost volume."""
    H, W = crop_shape
    return [(layers[0][1], D, H // s, W // s) for layers, D, s in zip(
        config["cost_regularization"], config["ndepths"],
        config["stage_strides"])]


def stage_costs(config, crop_shape):
    """[(K4's Cost, the U-Net's Cost)] of each stage on one reference
    view."""
    out = []
    for stage, (C, D, h, w) in enumerate(stage_shapes(config, crop_shape)):
        k4 = cost_volume_cost(config["views"], C, D, h, w)
        if stage:
            k4 = roofline.Cost(k4.nbytes + 4 * h * w, k4.ops)
        unet, _ = stack_cost(config["cost_regularization"][stage], (D, h, w),
                             3)
        out.append((k4, unet))
    return out


def _times(costs, n):
    return roofline.Cost(sum(c.nbytes for c in costs) * n,
                         sum(c.ops for c in costs) * n)


def pass_work(config, traffic, scene, crop_shape):
    """{"images", "views", "feature_net", "k4", "unet", "fine_unet"} of one
    pass: the images featurised (each image of the reference views' view
    sets once), the reference views, and the Costs of a pass's FPNs, cost
    volumes and U-Nets (all three stages), and of its last stage's U-Nets
    alone; ``crop_shape`` the cropped image's (H, W)."""
    refs = list(range(*traffic["images_range"]))
    images = {j for i in refs
              for j in scene.get_view_idxs(i, config["neighbors"])}
    stages = stage_costs(config, crop_shape)
    n, m = len(images), len(refs)
    return {"images": n, "views": m,
            "feature_net": _times([fpn_cost(config, crop_shape)], n),
            "k4": _times([k4 for k4, _ in stages], m),
            "unet": _times([unet for _, unet in stages], m),
            "fine_unet": _times([stages[-1][1]], m)}

