"""Per-component image counts for Rome16K
(reference: runners/rome16k/statistics.py)."""

import argparse
import os

import numpy as np

from limap_tpu_torch.runners.rome16k.Rome16K import Rome16K


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Rome16K component statistics (bundler format)")
    parser.add_argument("-a", "--bundler_path", type=str, required=True)
    parser.add_argument("-l", "--list_path", type=str,
                        default="bundle/list.orig.txt")
    parser.add_argument("--component_folder", type=str,
                        default="components")
    args = parser.parse_args(argv)

    dataset = Rome16K(
        os.path.join(args.bundler_path, args.list_path),
        os.path.join(args.bundler_path, args.component_folder))
    counts = [len(dataset.get_images_in_component(c))
              for c in range(dataset.count_components())]
    for index in np.argsort(counts)[::-1].tolist():
        print(index, counts[index])


if __name__ == "__main__":
    main()
