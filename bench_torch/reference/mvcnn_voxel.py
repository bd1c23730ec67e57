"""Reference of the ``mvcnn_voxel`` configuration (the paper's MVCNN
baseline in voxel space): the CNN, the plane sweep, the march and the hat
mapping of every ray; its depth is at the voxel of highest mapped score."""
from bench_torch.reference import common, plain


def run(scene, weights, config, traffic, contenders, device, tf32=False,
        block=1 << 18):
    """The ``plain.Judge`` of ``contenders`` against this reference over
    the reference views of ``traffic``."""
    refs = list(range(*traffic["images_range"]))
    views = common.Views(scene, weights, config, refs, device, tf32)
    judge = plain.Judge(contenders)
    for n, i in enumerate(refs):
        for lo, f, c, s, e, centres, dist in views.blocks(i, config, block):
            S = plain.hat_mapping(views.scores[i][lo:lo + len(c)], centres,
                                  c, s, e)
            judge.add(n, lo, S, dist, c)
    return judge
