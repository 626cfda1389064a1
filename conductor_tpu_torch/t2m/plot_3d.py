"""3-D skeleton animation for t2m joints (reference `utils/plot_script.py`;
the port of `conductor_tpu/t2m/plot_3d.py`).

Host-side matplotlib on the Agg backend (headless-safe); renders (T, J, 3)
joint positions over a kinematic chain to an mp4 / gif.  matplotlib is
imported inside the call, so the package imports on a host without it; a
call there raises `ImportError`.
"""

from __future__ import annotations

import numpy as np

_COLORS = ["red", "blue", "black", "darkred", "darkblue"]


def plot_3d_motion(
    save_path: str,
    kinematic_tree,
    joints: np.ndarray,
    title: str = "",
    figsize=(10, 10),
    fps: int = 120,
    radius: float = 4.0,
) -> str:
    """joints (T, J, 3) -> animated skeleton video at ``save_path``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation

    joints = np.asarray(joints).reshape(len(joints), -1, 3)
    data = joints.copy()

    # ground the motion: subtract floor height, center xz on the root path
    data[..., 1] -= data[..., 1].min()
    traj = data[:, 0, [0, 2]]
    data[..., 0] -= data[:, 0:1, 0]
    data[..., 2] -= data[:, 0:1, 2]

    fig = plt.figure(figsize=figsize)
    ax = fig.add_subplot(111, projection="3d")

    def init():
        ax.set_xlim3d([-radius / 2, radius / 2])
        ax.set_ylim3d([0, radius])
        ax.set_zlim3d([0, radius])
        ax.grid(False)
        if title:
            fig.suptitle(title, fontsize=20)

    def update(frame):
        ax.clear()
        init()
        ax.view_init(elev=120, azim=-90)
        ax.set_box_aspect(None, zoom=10 / 7.5)  # the reference's camera distance 7.5 of 10
        # floor plane following the trajectory
        ax.plot3D(
            traj[:frame + 1, 0] - traj[frame, 0],
            np.zeros(frame + 1),
            traj[:frame + 1, 1] - traj[frame, 1],
            linewidth=1.0, color="blue",
        )
        for i, (chain, color) in enumerate(zip(kinematic_tree, _COLORS)):
            lw = 4.0 if i < 5 else 2.0
            ax.plot3D(
                data[frame, chain, 0],
                data[frame, chain, 1],
                data[frame, chain, 2],
                linewidth=lw, color=color,
            )
        plt.axis("off")

    anim = FuncAnimation(
        fig, update, frames=len(data), init_func=init, interval=1000 / fps,
        repeat=False,
    )
    anim.save(save_path, fps=fps)
    plt.close(fig)
    return save_path
