"""Endpoint descriptors + NN endpoint matcher (learned-free, batched).

Each segment is described by an oriented intensity patch sampled around
each of its two endpoints, for all endpoints of all images in one
batched gather, and the matcher scores every line pair with the
``0.5 * max(s00 + s11, s01 + s10)`` endpoint combination before top-k /
mutual-NN selection.

Where this module departs from the reference on purpose:
match indices are int32 (the reference's int16 wrap above 32767 lines),
and :func:`match_all_neighbors_batched` rejects ``img_scale != 1`` when
it uploads the images itself (the reference scales the endpoints there
although the images are full size).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from limap_tpu_torch import resolve_device
from limap_tpu_torch.line2d.base import (BaseDetector, BaseMatcher,
                                         register_detector,
                                         register_extractor,
                                         register_matcher)
from limap_tpu_torch.util import io as limapio
from limap_tpu_torch.util import shape_bucket

PATCH = 8          # patch side in samples
PATCH_SPACING = 2.0  # pixels between samples


def _sample_patch_descriptors_batch(imgs: torch.Tensor,
                                    endpoints: torch.Tensor,
                                    directions: torch.Tensor
                                    ) -> torch.Tensor:
    """Oriented patch descriptor of each endpoint of each image.

    imgs [B, H, W] float in [0, 1] or uint8; endpoints [B, N, 2] xy;
    directions [B, N, 2] (line direction at that endpoint; its norm
    scales the patch).  Returns [B, N, D] L2-normalized, D = PATCH^2 + 2.
    """
    if imgs.dtype == torch.uint8:
        imgs = imgs.to(torch.float32) / 255.0
    B, H, W = imgs.shape
    g = torch.linspace(-(PATCH - 1) / 2, (PATCH - 1) / 2, PATCH,
                       device=imgs.device) * PATCH_SPACING
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    # rotate the grid into the line frame; shift the centre inward along
    # the segment so most samples lie on line support, not background
    dx, dy = directions[..., 0, None, None], directions[..., 1, None, None]
    inset = PATCH * PATCH_SPACING / 4.0
    cx = endpoints[..., 0, None, None] + dx * inset
    cy = endpoints[..., 1, None, None] + dy * inset
    px = cx + gx * dx - gy * dy        # [B, N, P, P]
    py = cy + gx * dy + gy * dx

    # bilinear sample by indexed loads: the corner index is clipped into
    # the image first, then the weight into [0, 1]
    x0 = torch.clamp(torch.floor(px).to(torch.int64), 0, W - 2)
    y0 = torch.clamp(torch.floor(py).to(torch.int64), 0, H - 2)
    fx = torch.clamp(px - x0, 0.0, 1.0)
    fy = torch.clamp(py - y0, 0.0, 1.0)
    flat_img = imgs.reshape(-1)
    base = (torch.arange(B, device=imgs.device)[:, None, None, None]
            * (H * W) + y0 * W + x0)
    v00 = flat_img[base]
    v01 = flat_img[base + 1]
    v10 = flat_img[base + W]
    v11 = flat_img[base + W + 1]
    vals = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)

    flat = vals.reshape(B, vals.shape[1], -1)
    mean = flat.mean(dim=-1, keepdim=True)
    centered = flat - mean
    std = torch.sqrt(torch.mean(centered * centered, dim=-1, keepdim=True))
    normed = centered / (torch.linalg.vector_norm(
        centered, dim=-1, keepdim=True) + 1e-8)
    # absolute photometric statistics as extra channels: a purely
    # contrast-normalized patch cannot tell identical strokes of
    # different brightness apart
    desc = torch.cat([normed, 4.0 * mean, 4.0 * std], dim=-1)
    return desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
                   + 1e-8)


def _sample_patch_descriptors(img: torch.Tensor, endpoints: torch.Tensor,
                              directions: torch.Tensor) -> torch.Tensor:
    """One image: img [H, W], endpoints and directions [N, 2] -> [N, D]."""
    return _sample_patch_descriptors_batch(img[None], endpoints[None],
                                           directions[None])[0]


def _gray_float(img) -> np.ndarray:
    """Any grayscale/colour uint8/float image -> float32 [H, W] in
    [0, 1]."""
    img = np.asarray(img, np.float32)
    if img.ndim == 3:
        img = img.mean(-1)
    if img.max() > 1.5:
        img = img / 255.0
    return img


def _gray_u8(img) -> np.ndarray:
    im = np.asarray(img)
    if im.dtype != np.uint8 or im.ndim != 2:
        im = np.clip(_gray_float(im) * 255.0, 0, 255).astype(np.uint8)
    return im


def _endpoints_and_dirs(segs: np.ndarray):
    """[N, >=4] segments -> endpoints [2N, 2] and the direction at each:
    +d at the start, -d at the end (pointing into the segment)."""
    d = segs[:, 2:4] - segs[:, :2]
    d = d / (np.linalg.norm(d, axis=1, keepdims=True) + 1e-8)
    return segs[:, :4].reshape(-1, 2), np.stack([d, -d], 1).reshape(-1, 2)


def _padded_endpoints(ids, segs: dict, scale: float = 1.0):
    """Endpoints and directions of all images padded to one line bucket:
    ([B, 2 Npad, 2], [B, 2 Npad, 2], Npad).  Padded rows sample a valid
    patch at the origin; the matcher masks them by line count."""
    Npad = shape_bucket(max(max((len(segs[i]) for i in ids), default=1), 1))
    ep = np.zeros((len(ids), 2 * Npad, 2), np.float32)
    dirs = np.zeros((len(ids), 2 * Npad, 2), np.float32)
    dirs[..., 0] = 1.0
    for r, i in enumerate(ids):
        s = np.asarray(segs[i])
        if len(s):
            e, d = _endpoints_and_dirs(s)
            ep[r, :len(e)] = e * scale
            dirs[r, :len(d)] = d * scale
    return ep, dirs, Npad


def _line_scores_normalized(segs: np.ndarray) -> np.ndarray:
    lengths = np.linalg.norm(segs[:, 2:4] - segs[:, :2], axis=1)
    score = segs[:, 4] if segs.shape[1] > 4 else np.sqrt(lengths)
    return score / (score.max() + 1e-8)


def _empty_descinfo(shape, dim):
    return {"image_shape": shape, "lines": np.zeros((0, 2)),
            "lines_score": np.zeros((0,)),
            "endpoints_desc": np.zeros((dim, 0))}


@register_extractor("patch_endpoints")
@register_detector("patch_endpoints")
class PatchEndpointsExtractor(BaseDetector):
    """Endpoint patch descriptors; the descinfo holds ``lines`` [2N, 2],
    ``lines_score`` [N] and ``endpoints_desc`` [D, 2N]."""

    def __init__(self, options=None):
        super().__init__(options)
        self.device = resolve_device((options or {}).get("device"))

    def get_module_name(self):
        return "patch_endpoints"

    def extract(self, camview, segs) -> dict:
        img = camview.read_image(set_gray=True)
        return self.compute_descinfo(img, np.asarray(segs))

    def compute_descinfo(self, img, segs) -> dict:
        img = _gray_float(img)
        if len(segs) == 0:
            return _empty_descinfo(img.shape, PATCH * PATCH)
        lines, dirs = _endpoints_and_dirs(segs)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                      device=self.device)
        desc = _sample_patch_descriptors(t(img), t(lines), t(dirs))
        return {"image_shape": img.shape, "lines": lines,
                "lines_score": _line_scores_normalized(segs),
                "endpoints_desc": desc.cpu().numpy().T}


def compute_descinfos_batch(imgs: dict, segs: dict, device=None) -> dict:
    """Patch-endpoint descinfos for MANY same-shape images in one
    batched call.  imgs: {img_id: [H, W] array}; segs: {img_id:
    [N, >=4]}.  Returns {img_id: descinfo} laid out as by
    PatchEndpointsExtractor.compute_descinfo."""
    device = resolve_device(device)
    ids = sorted(imgs.keys())
    ep, dirs, _ = _padded_endpoints(ids, segs)
    all_u8 = all(np.asarray(imgs[i]).dtype == np.uint8
                 and np.asarray(imgs[i]).ndim == 2 for i in ids)
    img_stack = np.stack([np.asarray(imgs[i]) if all_u8
                          else _gray_float(imgs[i]) for i in ids])
    H, W = img_stack.shape[1:]
    desc_all = _sample_patch_descriptors_batch(
        torch.as_tensor(img_stack, device=device),
        torch.as_tensor(ep, device=device),
        torch.as_tensor(dirs, device=device)).cpu().numpy()
    out = {}
    for r, i in enumerate(ids):
        s = np.asarray(segs[i])
        if len(s) == 0:
            out[i] = _empty_descinfo((H, W), PATCH * PATCH + 2)
            continue
        out[i] = {"image_shape": (H, W), "lines": s[:, :4].reshape(-1, 2),
                  "lines_score": _line_scores_normalized(s),
                  "endpoints_desc": desc_all[r, :2 * len(s)].T}
    return out


def box_downscale_u8(im: np.ndarray, factor: int) -> np.ndarray:
    """uint8 [H, W] -> [H / factor, W / factor]: the mean of each
    factor x factor box, rounded half up (what area interpolation gives
    for an exact integer factor, to within one grey level)."""
    H, W = im.shape
    if H % factor or W % factor:
        raise ValueError(f"image {H}x{W} is not a multiple of {factor}")
    boxes = im.reshape(H // factor, factor, W // factor, factor)
    total = boxes.sum(axis=(1, 3), dtype=np.uint32)
    area = factor * factor
    return ((total + area // 2) // area).astype(np.uint8)


def upload_image_u8(img, downscale: int = 1, device=None) -> torch.Tensor:
    """One grayscale image as a flat uint8 tensor on ``device``.

    ``downscale`` ships a 1/s-resolution copy (box mean): descriptor
    patches sample at PATCH_SPACING = 2 px anyway, so a half-resolution
    image keeps the sampled signal with a quarter of the bytes.  Pass
    img_scale = 1 / downscale to match_all_neighbors_batched."""
    device = resolve_device(device)
    im = _gray_u8(img)
    if downscale != 1:
        im = box_downscale_u8(im, downscale)
    return torch.as_tensor(np.ascontiguousarray(im).reshape(-1),
                           device=device)


def match_all_neighbors_batched(imgs: dict, segs: dict, nbrs: dict,
                                topk: int = 2, min_score: float = 0.5,
                                chunk: int = 125,
                                device_imgs: dict = None,
                                img_scale: float = 1.0,
                                device=None) -> dict:
    """Fused describe+match: descriptors are computed on the device and
    fed straight into the pair scorer, and the match threshold is
    applied there, so only a (good-mask, index) pair per candidate comes
    back, once per chunk of ``chunk`` image pairs.  ``device_imgs``
    takes the per-image flat uint8 tensors of :func:`upload_image_u8`
    (``imgs`` must still be given: it supplies H and W); they may be
    downscaled by ``img_scale``.  Returns {img_id: {nbr_id: [M, 2]}}.
    """
    device = resolve_device(device)
    if not imgs:
        raise ValueError("pass `imgs` alongside device_imgs to supply H, W")
    ids = sorted(imgs.keys())
    id2row = {img_id: r for r, img_id in enumerate(ids)}
    n_lines = {i: len(segs[i]) for i in ids}
    H, W = np.asarray(imgs[ids[0]]).shape[:2]
    if device_imgs is not None:
        # scaling BOTH endpoints and (unit) directions by img_scale
        # samples the downscaled image over the same physical footprint:
        # every grid offset is a multiple of the direction vector
        if img_scale != 1.0:
            H, W = int(H * img_scale), int(W * img_scale)
        if device_imgs[ids[0]].shape[0] != H * W:
            raise ValueError("device image size does not match img_scale")
        img_stack = torch.cat([device_imgs[i].to(device) for i in ids]) \
            .reshape(len(ids), H, W)
    else:
        if img_scale != 1.0:
            raise ValueError("img_scale applies to downscaled device_imgs "
                             "only; images uploaded here are full size")
        img_stack = torch.as_tensor(
            np.stack([_gray_u8(imgs[i]) for i in ids]), device=device)
    ep, dirs, Npad = _padded_endpoints(ids, segs, img_scale)
    desc = _sample_patch_descriptors_batch(
        img_stack, torch.as_tensor(ep, device=device),
        torch.as_tensor(dirs, device=device))        # [B, 2 Npad, D]
    stack = desc.transpose(1, 2).contiguous()        # [B, D, 2 Npad]

    pairs = [(i, j) for i in sorted(nbrs) for j in nbrs[i]]
    k = min(topk if topk > 0 else 1, Npad)
    rows = lambda v: torch.as_tensor(v, dtype=torch.int64, device=device)
    pend = []
    for c0 in range(0, len(pairs), chunk):
        sub = pairs[c0:c0 + chunk]
        pend.append((sub, _batched_line_matches(
            stack, rows([id2row[a] for a, _ in sub]),
            rows([id2row[b] for _, b in sub]),
            rows([n_lines[a] for a, _ in sub]),
            rows([n_lines[b] for _, b in sub]), min_score, k)))
    result = {}
    for sub, (good, idx) in pend:
        # one download per chunk, then one nonzero over [P, L, k]
        g = good.cpu().numpy()
        ix = idx.cpu().numpy()
        pp, rr, kk = np.nonzero(g)         # row-major: pp ascending
        jj = ix[pp, rr, kk].astype(np.int64)
        splits = np.cumsum(np.bincount(pp, minlength=len(sub)))[:-1]
        ii_split = np.split(rr.astype(np.int64), splits)
        jj_split = np.split(jj, splits)
        for p, (a, b) in enumerate(sub):
            result.setdefault(a, {})[b] = np.stack(
                [ii_split[p], jj_split[p]], 1)
    return result


def _batched_line_scores_topk(stack: torch.Tensor, rows1: torch.Tensor,
                              rows2: torch.Tensor, n2: torch.Tensor,
                              k: int):
    """Pair scoring + top-k.  stack [I, D, 2L] holds every image's
    endpoint descriptors once; rows1 / rows2 [P] pick the pairs, n2 [P]
    is the second image's line count (padded columns score -1e9).
    Returns per-line top-k (values, int32 indices), each [P, L, k]."""
    d1 = stack[rows1]  # [P, D, 2L]
    d2 = stack[rows2]
    s = torch.einsum("pdi,pdj->pij", d1, d2)
    P, L = s.shape[0], s.shape[1] // 2
    s = s.reshape(P, L, 2, L, 2)
    line_scores = 0.5 * torch.maximum(s[:, :, 0, :, 0] + s[:, :, 1, :, 1],
                                      s[:, :, 0, :, 1] + s[:, :, 1, :, 0])
    valid2 = torch.arange(L, device=s.device)[None, :] < n2[:, None]
    line_scores = torch.where(valid2[:, None, :], line_scores,
                              line_scores.new_tensor(-1e9))
    vals, idx = torch.topk(line_scores, k, dim=-1)
    return vals, idx.to(torch.int32)


def _batched_line_matches(stack, rows1, rows2, n1, n2, min_score: float,
                          k: int):
    """Top-k pair scores thresholded on the device: (good bool [P, L, k],
    idx int32 [P, L, k]); rows past a first image's n1 lines are never
    good."""
    vals, idx = _batched_line_scores_topk(stack, rows1, rows2, n2, k)
    L = vals.shape[1]
    valid1 = torch.arange(L, device=vals.device)[None, :] < n1[:, None]
    return (vals >= min_score) & valid1[:, :, None], idx


def _endpoint_line_scores(s: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """[2 N1, 2 N2] endpoint scores -> [N1, N2] line scores: the better
    of the two endpoint pairings, halved."""
    s = s.reshape(n1, 2, n2, 2)
    return 0.5 * torch.maximum(s[:, 0, :, 0] + s[:, 1, :, 1],
                               s[:, 0, :, 1] + s[:, 1, :, 0])


def _line_scores(desc1: torch.Tensor, desc2: torch.Tensor) -> torch.Tensor:
    """[D, 2*N1] x [D, 2*N2] endpoint descs -> [N1, N2] line scores."""
    return _endpoint_line_scores(desc1.T @ desc2, desc1.shape[1] // 2,
                                 desc2.shape[1] // 2)


@register_matcher("nn_endpoints")
class NNEndpointsMatcher(BaseMatcher):
    """Top-k / mutual-NN line matching on endpoint scores."""

    def __init__(self, extractor, options=None):
        super().__init__(extractor, options)
        options = options or {}
        self.device = resolve_device(options.get("device"))
        self.min_score = options.get("min_score", 0.2)

    def get_module_name(self):
        return "nn_endpoints"

    def match_pair(self, descinfo1, descinfo2) -> np.ndarray:
        d1 = np.asarray(descinfo1["endpoints_desc"], np.float32)
        d2 = np.asarray(descinfo2["endpoints_desc"], np.float32)
        if d1.shape[1] == 0 or d2.shape[1] == 0:
            return np.zeros((0, 2), np.int64)
        scores = _line_scores(
            torch.as_tensor(d1, device=self.device),
            torch.as_tensor(d2, device=self.device)).cpu().numpy()
        if self.topk == 0:
            # mutual nearest neighbour
            best2 = scores.argmax(1)
            best1 = scores.argmax(0)
            i = np.arange(scores.shape[0])
            mutual = best1[best2[i]] == i
            good = mutual & (scores[i, best2[i]] >= self.min_score)
            return np.stack([i[good], best2[i][good]], axis=1)
        k = min(self.topk, scores.shape[1])
        idx = np.argsort(-scores, axis=1)[:, :k]
        i = np.repeat(np.arange(scores.shape[0]), k)
        j = idx.reshape(-1)
        good = scores[i, j] >= self.min_score
        return np.stack([i[good], j[good]], axis=1)

    def match_all_neighbors(self, output_folder, image_ids, neighbors,
                            descinfo_folder, skip_exists: bool = False):
        """Batched override of the per-pair loop: all descinfos upload
        once and every neighbour pair is scored in a few chunked device
        calls.  Mutual-NN mode (topk == 0) takes the generic per-pair
        path."""
        if self.topk == 0:
            return super().match_all_neighbors(
                output_folder, image_ids, neighbors, descinfo_folder,
                skip_exists)
        matches_folder = self.get_matches_folder(output_folder)
        limapio.check_makedirs(matches_folder)
        todo = [i for i in image_ids if not (skip_exists and os.path.isfile(
            os.path.join(matches_folder, f"matches_{i}.npy")))]
        if not todo:
            return matches_folder
        descinfos = {i: self.extractor.read_descinfo(descinfo_folder, i)
                     for i in image_ids}
        pairs = [(i, ng) for i in todo for ng in neighbors[i]]
        nonempty = {i for i in image_ids
                    if np.asarray(
                        descinfos[i]["endpoints_desc"]).shape[1] > 0}
        live = [p for p in pairs
                if p[0] in nonempty and p[1] in nonempty]
        result = batched_match_pairs(
            {i: descinfos[i] for i in nonempty}, live,
            topk=self.topk, min_score=self.min_score,
            device=self.device) if live else {}
        for img_id in todo:
            matches = {ng: result.get(
                (img_id, ng), np.zeros((0, 2), np.int64))
                for ng in neighbors[img_id]}
            self.save_match(matches_folder, img_id, matches)
        return matches_folder


def batched_match_pairs(descinfos: dict, pairs, topk: int = 10,
                        min_score: float = 0.2, chunk: int = 64,
                        device=None):
    """Match many image pairs in a few device calls.

    descinfos: {img_id: descinfo}; pairs: [(id1, id2), ...].
    Returns {(id1, id2): [M, 2] int matches}.  Descriptors are padded to
    one line bucket, uploaded once as one [I, D, 2L] stack, and scored
    with one gather + product + top-k per chunk of pairs.
    """
    device = resolve_device(device)
    ids = sorted(descinfos.keys())
    id2row = {img_id: r for r, img_id in enumerate(ids)}
    n_lines = {i: np.asarray(descinfos[i]["endpoints_desc"]).shape[1] // 2
               for i in ids}
    Lpad = shape_bucket(max(max(n_lines.values()), 1))
    D = max(np.asarray(descinfos[i]["endpoints_desc"]).shape[0]
            for i in ids)
    stack = np.zeros((len(ids), D, 2 * Lpad), np.float32)
    for r, i in enumerate(ids):
        d = np.asarray(descinfos[i]["endpoints_desc"], np.float32)
        stack[r, :d.shape[0], :d.shape[1]] = d
    d_stack = torch.as_tensor(stack, device=device)
    k = min(topk if topk > 0 else 1, Lpad)
    rows = lambda v: torch.as_tensor(v, dtype=torch.int64, device=device)
    pend = []
    for c0 in range(0, len(pairs), chunk):
        sub = pairs[c0:c0 + chunk]
        pend.append((sub, _batched_line_scores_topk(
            d_stack, rows([id2row[a] for a, _ in sub]),
            rows([id2row[b] for _, b in sub]),
            rows([n_lines[b] for _, b in sub]), k)))
    result = {}
    for sub, (vals, idx) in pend:
        vals = vals.cpu().numpy()
        idx = idx.cpu().numpy()
        for p, (a, b) in enumerate(sub):
            n1 = n_lines[a]
            ii = np.repeat(np.arange(n1), k)
            jj = idx[p, :n1].reshape(-1)
            good = vals[p, :n1].reshape(-1) >= min_score
            result[(a, b)] = np.stack([ii[good], jj[good]], 1)
    return result


# ------------------------------------------------ the learned endpoint zoo
@register_extractor("superpoint_endpoints")
@register_detector("superpoint_endpoints")
class SuperPointEndpointsExtractor(BaseDetector):
    """SuperPoint descriptors at the two endpoints of every segment (the
    reference's default learned line descriptor): ``lines`` [2N, 2],
    ``lines_score`` [N] (segment score x sqrt(length), max-normalized)
    and ``endpoints_desc`` [256, 2N], sampled on kernel S from the dense
    descriptor grid, which stays on the device."""

    def __init__(self, options=None):
        super().__init__(options)
        from limap_tpu_torch.point2d.superpoint import SuperPoint
        self.device = resolve_device((options or {}).get("device"))
        self.sp = SuperPoint(weight_path=self.weight_path,
                             device=self.device)

    def get_module_name(self):
        return "superpoint_endpoints"

    def extract(self, camview, segs) -> dict:
        img = camview.read_image(set_gray=True)
        return self.compute_descinfo(img, np.asarray(segs))

    def compute_descinfo(self, img, segs) -> dict:
        from limap_tpu_torch.point2d.superpoint import sample_descriptors
        img = _gray_float(img)
        if len(segs) == 0:
            return _empty_descinfo(img.shape, 256)
        segs = np.asarray(segs)
        lines = segs[:, :4].reshape(-1, 2)
        lengths = np.linalg.norm(segs[:, :2] - segs[:, 2:4], axis=1)
        score = (segs[:, -1] if segs.shape[1] > 4
                 else np.ones(len(segs))) * np.sqrt(lengths)
        score = score / (score.max() + 1e-8)
        _, grid = self.sp._forward(img)
        desc = sample_descriptors(grid, torch.as_tensor(
            lines, dtype=torch.float32, device=self.device))
        return {"image_shape": img.shape, "lines": lines,
                "lines_score": score, "endpoints_desc": desc.cpu().numpy().T}


@register_matcher("superglue_endpoints")
class SuperGlueEndpointsMatcher(BaseMatcher):
    """The reference's learned line matcher: the SuperGlue GNN over all
    endpoints of both images, the line score the better endpoint
    pairing, then the optimal transport over line scores (kernel R) when
    ``topk`` is 0, else each line's top ``topk``.  The checkpoint comes
    from ``superglue_weight_path`` or ``weight_path`` in the options."""

    def __init__(self, extractor, options=None):
        super().__init__(extractor, options)
        options = options or {}
        if extractor.get_module_name() != "superpoint_endpoints":
            raise ValueError("superglue_endpoints needs 256-d SuperPoint "
                             "endpoint descriptors (superpoint_endpoints)")
        from limap_tpu_torch.point2d.superglue import SuperGlue
        weight_path = (options.get("superglue_weight_path")
                       or options.get("weight_path"))
        if weight_path is None:
            import warnings
            warnings.warn(
                "superglue_endpoints constructed WITHOUT a checkpoint "
                "(no 'weight_path' in the matcher options): SuperGlue "
                "runs with random weights and produces garbage matches."
                " Pass line2d.matcher.weight_path, or use the "
                "weight-free 'sinkhorn_endpoints' matcher instead.",
                stacklevel=2)
        self.device = resolve_device(options.get("device"))
        self.sg = SuperGlue(weight_path=weight_path,
                            match_threshold=options.get("match_threshold",
                                                        0.2),
                            device=self.device)

    def get_module_name(self):
        return "superglue_endpoints"

    def match_pair(self, descinfo1, descinfo2) -> np.ndarray:
        from limap_tpu_torch.point2d.superglue import get_matches
        d1 = np.asarray(descinfo1["endpoints_desc"], np.float32)
        d2 = np.asarray(descinfo2["endpoints_desc"], np.float32)
        if d1.shape[1] == 0 or d2.shape[1] == 0:
            return np.zeros((0, 2), np.int64)
        data = {
            "image_shape0": descinfo1["image_shape"],
            "image_shape1": descinfo2["image_shape"],
            "keypoints0": np.asarray(descinfo1["lines"], np.float32),
            "keypoints1": np.asarray(descinfo2["lines"], np.float32),
            "scores0": np.repeat(np.asarray(
                descinfo1["lines_score"], np.float32), 2),
            "scores1": np.repeat(np.asarray(
                descinfo2["lines_score"], np.float32), 2),
            "descriptors0": d1,
            "descriptors1": d2,
        }
        n1, n2 = d1.shape[1] // 2, d2.shape[1] // 2
        line_scores = _endpoint_line_scores(self.sg.scores(data), n1, n2)
        if self.topk == 0:
            Z = self.sg.solve_optimal_transport(line_scores)
            m0 = get_matches(Z, self.sg.match_threshold)[0]
            ids1 = np.arange(n1)[m0 != -1]
            return np.stack([ids1, m0[m0 != -1]], 1)
        scores = line_scores.cpu().numpy()
        k = min(self.topk, n2)
        idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        return np.stack([np.repeat(np.arange(n1), k), idx.reshape(-1)], 1)


@register_matcher("sinkhorn_endpoints")
class SinkhornEndpointsMatcher(NNEndpointsMatcher):
    """OT-based line matching on endpoint scores without the learned
    GNN (the weight-free fallback): the line scores over 0.1 through 50
    Sinkhorn iterations with a dustbin (kernel R), then mutual argmax of
    the assignment above ``match_threshold``.  Every pair takes this path
    (the reference's batched top-k override of ``nn_endpoints`` is not
    inherited: there it bypasses the Sinkhorn solve whenever ``topk`` is
    not 0)."""

    def __init__(self, extractor, options=None):
        super().__init__(extractor, options)
        options = options or {}
        self.bin_score = options.get("bin_score", 0.5)
        self.match_threshold = options.get("match_threshold", 0.2)

    def get_module_name(self):
        return "sinkhorn_endpoints"

    def match_pair(self, descinfo1, descinfo2) -> np.ndarray:
        from limap_tpu_torch.point2d.matching import (log_sinkhorn,
                                                      mutual_argmax_matches)
        d1 = np.asarray(descinfo1["endpoints_desc"], np.float32)
        d2 = np.asarray(descinfo2["endpoints_desc"], np.float32)
        if d1.shape[1] == 0 or d2.shape[1] == 0:
            return np.zeros((0, 2), np.int64)
        line_scores = _line_scores(torch.as_tensor(d1, device=self.device),
                                   torch.as_tensor(d2, device=self.device))
        Z = log_sinkhorn(line_scores / 0.1, self.bin_score)
        P = np.exp(Z[:-1, :-1].cpu().numpy())
        return mutual_argmax_matches(P, self.match_threshold)

    def match_all_neighbors(self, output_folder, image_ids, neighbors,
                            descinfo_folder, skip_exists: bool = False):
        return BaseMatcher.match_all_neighbors(
            self, output_folder, image_ids, neighbors, descinfo_folder,
            skip_exists)
