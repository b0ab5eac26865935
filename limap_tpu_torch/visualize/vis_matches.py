"""Match visualization on matplotlib figures.

plot_images / plot_matches / plot_lines / plot_color_line_matches /
plot_color_lines / save_plot.  seaborn is not required: the husl/hls
palettes are generated from matplotlib's hsv colormap with
matched saturation.
"""

from __future__ import annotations

import numpy as np


def _palette(n, seed=None):
    import matplotlib

    h = np.linspace(0, 1, n, endpoint=False)
    if seed is not None:
        rng = np.random.default_rng(seed)
        rng.shuffle(h)
    return [tuple(matplotlib.colors.hsv_to_rgb([hi, 0.7, 0.9]))
            for hi in h]


def plot_images(imgs, titles=None, cmaps="gray", dpi=100, size=6,
                pad=0.5):
    """Create a figure with one axis per image."""
    import matplotlib.pyplot as plt

    n = len(imgs)
    if not isinstance(cmaps, (list, tuple)):
        cmaps = [cmaps] * n
    ratios = [i.shape[1] / i.shape[0] for i in imgs]
    figsize = [sum(ratios) * size * 0.75, size * 0.75]
    fig, ax = plt.subplots(1, n, figsize=figsize, dpi=dpi,
                           gridspec_kw={"width_ratios": ratios})
    if n == 1:
        ax = [ax]
    for i in range(n):
        ax[i].imshow(imgs[i], cmap=plt.get_cmap(cmaps[i]))
        ax[i].set_axis_off()
        if titles:
            ax[i].set_title(titles[i])
    fig.tight_layout(pad=pad)
    return fig


def plot_keypoints(kpts, colors="lime", ps=2):
    import matplotlib.pyplot as plt

    axes = plt.gcf().axes
    if not isinstance(kpts, (list, tuple)):
        kpts = [kpts]
    for a, k in zip(axes, kpts):
        k = np.asarray(k)
        a.scatter(k[:, 0], k[:, 1], c=colors, s=ps, linewidths=0)


def plot_matches(kpts0, kpts1, color=None, lw=1.5, ps=4,
                 indices=(0, 1)):
    """Draw match lines across two axes of the current figure."""
    import matplotlib
    import matplotlib.pyplot as plt

    fig = plt.gcf()
    ax = fig.axes
    assert len(ax) > max(indices)
    ax0, ax1 = ax[indices[0]], ax[indices[1]]
    fig.canvas.draw()
    kpts0 = np.asarray(kpts0)
    kpts1 = np.asarray(kpts1)
    assert len(kpts0) == len(kpts1)
    if color is None:
        color = _palette(len(kpts0), seed=0)
    elif not isinstance(color[0], (tuple, list)):
        color = [color] * len(kpts0)
    transFigure = fig.transFigure.inverted()
    f0 = transFigure.transform(ax0.transData.transform(kpts0))
    f1 = transFigure.transform(ax1.transData.transform(kpts1))
    fig.lines += [
        matplotlib.lines.Line2D((f0[i, 0], f1[i, 0]),
                                (f0[i, 1], f1[i, 1]), zorder=1,
                                transform=fig.transFigure, c=color[i],
                                linewidth=lw)
        for i in range(len(kpts0))]
    ax0.autoscale(enable=False)
    ax1.autoscale(enable=False)
    if ps > 0:
        ax0.scatter(kpts0[:, 0], kpts0[:, 1], c=color, s=ps)
        ax1.scatter(kpts1[:, 0], kpts1[:, 1], c=color, s=ps)


def plot_lines(lines, line_colors="orange", point_color="cyan", ps=4,
               lw=2, indices=(0, 1), alpha=1):
    """Draw 2D segments + endpoints per axis."""
    import matplotlib
    import matplotlib.pyplot as plt

    if not isinstance(line_colors, list):
        line_colors = [[line_colors] * len(line) for line in lines]
    for i in range(len(lines)):
        if not isinstance(line_colors[i], (list, np.ndarray)):
            line_colors[i] = [line_colors[i]] * len(lines[i])
    fig = plt.gcf()
    ax = fig.axes
    assert len(ax) > max(indices)
    axes = [ax[i] for i in indices]
    fig.canvas.draw()
    for a, line, lc in zip(axes, lines, line_colors):
        line = np.asarray(line)
        for i in range(len(line)):
            a.add_line(matplotlib.lines.Line2D(
                (line[i, 0, 0], line[i, 1, 0]),
                (line[i, 0, 1], line[i, 1, 1]), zorder=1, c=lc[i],
                linewidth=lw, alpha=alpha))
        pts = line.reshape(-1, 2)
        a.scatter(pts[:, 0], pts[:, 1], c=point_color, s=ps,
                  linewidths=0, zorder=2, alpha=alpha)


def plot_color_line_matches(lines, correct_matches=None, lw=2,
                            indices=(0, 1)):
    """Matched lines in the same color across images."""
    import matplotlib
    import matplotlib.pyplot as plt

    n_lines = len(lines[0])
    colors = _palette(n_lines, seed=0)
    alphas = np.ones(n_lines)
    if correct_matches is not None:
        alphas[~np.asarray(correct_matches)] = 0.2
    fig = plt.gcf()
    ax = fig.axes
    assert len(ax) > max(indices)
    axes = [ax[i] for i in indices]
    fig.canvas.draw()
    for a, line in zip(axes, lines):
        line = np.asarray(line)
        transFigure = fig.transFigure.inverted()
        e0 = transFigure.transform(a.transData.transform(line[:, 0]))
        e1 = transFigure.transform(a.transData.transform(line[:, 1]))
        fig.lines += [
            matplotlib.lines.Line2D((e0[i, 0], e1[i, 0]),
                                    (e0[i, 1], e1[i, 1]), zorder=1,
                                    transform=fig.transFigure,
                                    c=colors[i], alpha=alphas[i],
                                    linewidth=lw)
            for i in range(n_lines)]


def plot_color_lines(lines, correct_matches, wrong_matches, lw=2,
                     indices=(0, 1)):
    """Green = correct, red = wrong, blue = rest."""
    import matplotlib
    import matplotlib.pyplot as plt

    blue, red, green = (0.2, 0.4, 0.9), (0.9, 0.2, 0.2), (0.2, 0.8, 0.3)
    colors = [np.tile(np.asarray(blue), (len(line), 1))
              for line in lines]
    for i, c in enumerate(colors):
        c[np.asarray(correct_matches[i])] = green
        c[np.asarray(wrong_matches[i])] = red
    fig = plt.gcf()
    ax = fig.axes
    assert len(ax) > max(indices)
    axes = [ax[i] for i in indices]
    fig.canvas.draw()
    for a, line, c in zip(axes, lines, colors):
        line = np.asarray(line)
        transFigure = fig.transFigure.inverted()
        e0 = transFigure.transform(a.transData.transform(line[:, 0]))
        e1 = transFigure.transform(a.transData.transform(line[:, 1]))
        fig.lines += [
            matplotlib.lines.Line2D((e0[i, 0], e1[i, 0]),
                                    (e0[i, 1], e1[i, 1]), zorder=1,
                                    transform=fig.transFigure, c=c[i],
                                    linewidth=lw)
            for i in range(len(line))]


def save_plot(path, **kw):
    """Save the current figure without margins."""
    import matplotlib.pyplot as plt

    plt.savefig(path, bbox_inches="tight", pad_inches=0, **kw)
