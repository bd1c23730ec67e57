"""What the references of the pass configurations share: the features of
every image, each reference view's segments and plane-sweep scores, and
the march of an image's rays, computed in blocks."""
import contextlib

import torch

from bench_torch.reference import plain


@contextlib.contextmanager
def precision(tf32):
    """float32 with TF32 off, or (the control) TF32 on for the CNN's
    convolutions and any float32 product."""
    cudnn, matmul = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul


class Views:
    """Per reference view of a pass: its segments (start, end), its camera
    centre and its (N, D) plane-sweep scores."""

    def __init__(self, scene, weights, config, refs, device, tf32,
                 block=1 << 17):
        layers = config["cnn"]["layers"]
        padding = config["padding"]
        H, W = scene.image_shape
        needed = sorted({j for i in refs
                         for j in scene.get_view_idxs(i, config["neighbors"])})
        with precision(tf32):
            feats = {j: plain.cnn_features(
                torch.as_tensor(scene.get_image(j).image_u8, device=device),
                weights, layers, padding, config["cnn"]["bn_eps"])
                for j in needed}
        self.bbox = plain.f32(scene.bbox.reshape(-1), device)
        self.segments, self.centers, self.scores = {}, {}, {}
        for i in refs:
            views = scene.get_view_idxs(i, config["neighbors"])
            cams = [scene.get_image(j).camera for j in views]
            P = plain.f32([c.P for c in cams], device)
            center = plain.f32(cams[0].center[:3, 0], device)
            start, end = plain.segments(H, W, plain.f32(cams[0].P_pinv,
                                                        device),
                                        center, self.bbox)
            features = torch.stack([feats[j] for j in views])
            self.scores[i] = torch.cat([
                plain.plane_sweep(features, P, start[lo:lo + block],
                                  end[lo:lo + block], padding, H, W,
                                  config["depth_planes"])
                for lo in range(0, start.shape[0], block)])
            self.segments[i] = (start, end)
            self.centers[i] = center
            del features
        del feats

    def blocks(self, i, config, block):
        """Yield, for view i's rays in blocks [lo, lo + B): (lo, flat (B, m)
        int32, counts (B,), start, end, voxel centres (B, m, 3) and their
        distances from the camera (B, m)), from one march of the view; m is
        the block's longest march."""
        start, end = self.segments[i]
        flat, counts = plain.march(self.bbox, start, end,
                                   config["grid_shape"],
                                   config["max_marched_voxels"])
        for lo in range(0, start.shape[0], block):
            # past the block's longest march every row is empty
            m = max(int(counts[lo:lo + block].max()), 1)
            f = flat[lo:lo + block, :m].contiguous()
            centres, dist = plain.voxel_centers_distance(
                f, self.bbox, config["grid_shape"], self.centers[i])
            yield (lo, f, counts[lo:lo + block], start[lo:lo + block],
                   end[lo:lo + block], centres, dist)
