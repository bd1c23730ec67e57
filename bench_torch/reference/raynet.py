"""Reference of the ``raynet`` configuration: the CNN, the plane sweep,
``bp_iterations`` sweeps of sum-product BP over every ray of every
reference view against one occupancy grid (reset to the prior at each
iteration, each view's messages summed from zero and then added), and the
posterior depth distribution of every ray."""
import torch

from bench_torch.reference import common, plain


def run(scene, weights, config, traffic, contenders, device, tf32=False,
        block=1 << 18):
    """The ``plain.Judge`` of ``contenders`` against this reference over
    the reference views of ``traffic``."""
    refs = list(range(*traffic["images_range"]))
    views = common.Views(scene, weights, config, refs, device, tf32)
    gx, gy, gz = config["grid_shape"]
    cells = gx * gy * gz
    M = config["max_marched_voxels"]
    gamma = config["gamma"]
    prior = float(torch.log(torch.tensor(gamma, dtype=torch.float32))
                  - torch.log(torch.tensor(1.0 - gamma, dtype=torch.float32)))
    messages = {i: torch.zeros((views.segments[i][0].shape[0], M),
                               dtype=torch.float32, device=device)
                for i in refs}
    grid = None
    for it in range(config["bp_iterations"]):
        total = torch.full((cells,), prior, dtype=torch.float32,
                           device=device)
        for i in refs:
            image = torch.zeros(cells, dtype=torch.float32, device=device)
            for lo, f, c, s, e, centres, _ in views.blocks(i, config, block):
                S = plain.hat_mapping(views.scores[i][lo:lo + len(c)],
                                      centres, c, s, e)
                rows = messages[i][lo:lo + len(c), :f.shape[1]]
                new, scatter = plain.bp_messages(
                    S, f, c, None if it == 0 else rows, grid, prior, cells)
                rows.copy_(new)
                image += scatter
            total += image
        grid = total
    judge = plain.Judge(contenders)
    for n, i in enumerate(refs):
        for lo, f, c, s, e, centres, dist in views.blocks(i, config, block):
            S = plain.hat_mapping(views.scores[i][lo:lo + len(c)], centres,
                                  c, s, e)
            post = plain.bp_posterior(
                S, f, c, messages[i][lo:lo + len(c), :f.shape[1]], grid)
            judge.add(n, lo, post, dist, c)
    return judge
