"""Detector/extractor/matcher sanity demo
(reference: scripts/test_matching.py): detect on two images, match,
write overlay visualizations.  Defaults to a synthetic image pair so
it runs without any dataset; pass --img1/--img2 for real frames."""

import argparse
import os
import time

import numpy as np

from limap_tpu_torch.line2d import get_detector, get_extractor, get_matcher


def synthetic_pair(seed=0, H=240, W=320, n_lines=8):
    import cv2
    rng = np.random.default_rng(seed)
    img = np.full((H, W), 220, np.uint8)
    for _ in range(n_lines):
        p1 = rng.uniform([20, 20], [W - 20, H - 20]).astype(int)
        p2 = rng.uniform([20, 20], [W - 20, H - 20]).astype(int)
        cv2.line(img, tuple(p1), tuple(p2), int(rng.integers(20, 120)),
                 2)
    shift = np.float32([[1, 0, 4.0], [0, 1, 3.0]])
    img2 = cv2.warpAffine(img, shift, (W, H), borderValue=220)
    return img, img2


def main(argv=None):
    import cv2

    parser = argparse.ArgumentParser(description="matching sanity demo")
    parser.add_argument("--img1", type=str, default=None)
    parser.add_argument("--img2", type=str, default=None)
    parser.add_argument("--detector", type=str, default="lsd")
    parser.add_argument("--extractor", type=str,
                        default="patch_endpoints")
    parser.add_argument("--matcher", type=str, default="nn_endpoints")
    parser.add_argument("--out_dir", type=str, default="/tmp")
    parser.add_argument("--device", type=str, default=None)
    args = parser.parse_args(argv)

    if args.img1 and args.img2:
        img1 = cv2.imread(args.img1, cv2.IMREAD_GRAYSCALE)
        img2 = cv2.imread(args.img2, cv2.IMREAD_GRAYSCALE)
    else:
        img1, img2 = synthetic_pair()

    detector = get_detector({"method": args.detector}, device=args.device)
    extractor = get_extractor({"method": args.extractor}, device=args.device)
    matcher = get_matcher({"method": args.matcher, "topk": 0},
                          extractor, device=args.device)

    segs1 = detector.take_longest_k(detector.detect_array(img1))[0]
    segs2 = detector.take_longest_k(detector.detect_array(img2))[0]
    d1 = extractor.compute_descinfo(img1, segs1)
    d2 = extractor.compute_descinfo(img2, segs2)
    t0 = time.time()
    matches = matcher.match_pair(d1, d2)
    print(f"{len(segs1)} x {len(segs2)} segments, "
          f"{len(matches)} matches, "
          f"matching time: {time.time() - t0:.3f}s")

    from limap_tpu_torch.visualize.vis_utils import draw_segments
    c1 = cv2.cvtColor(img1, cv2.COLOR_GRAY2BGR)
    c2 = cv2.cvtColor(img2, cv2.COLOR_GRAY2BGR)
    cv2.imwrite(os.path.join(args.out_dir, "img1_det.png"),
                draw_segments(c1.copy(), segs1, color=[0, 255, 0]))
    cv2.imwrite(os.path.join(args.out_dir, "img2_det.png"),
                draw_segments(c2.copy(), segs2, color=[0, 255, 0]))
    from limap_tpu_torch.visualize.vis_utils import draw_matches
    vis = draw_matches(c1, segs1, c2, segs2, matches)
    cv2.imwrite(os.path.join(args.out_dir, "matches.png"), vis)
    print(f"wrote visualizations to {args.out_dir}")


if __name__ == "__main__":
    main()
