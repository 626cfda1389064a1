"""Motion post-processing and skeleton-video rendering (host-side).

A copy of `conductor_tpu/viz/motion.py` (the reference's
`Contrastive_Stage/utils/motion_utils.py:28-192`, with ProspectiveCup's
Butterworth band-pass), kept in the port so that it imports nothing of the
JAX package: Savitzky-Golay smoothing, shoulder / hip normalization,
OpenCV skeleton rendering with fading wrist traces, 30-fps AVI writing,
the COCO(17) <-> ConductorMotion100(13) keypoint converters, and muxing
the audio back in.  numpy and scipy only, on the host.

`cv2` is imported lazily inside `render_frame` / `render_motion_video`, so
nothing else here needs it, and `mux_audio` returns the silent video when
neither ffmpeg nor moviepy is installed.  Where cv2 is missing the serving
CLIs say that no video was rendered (``--save_npy`` keeps the motion).
"""

from __future__ import annotations

import math
import os

import numpy as np
from scipy.signal import butter, savgol_filter, sosfiltfilt

# Skeleton pairs in COCO-17 index space with the fake neck (17) used by the
# reference renderer (`motion_utils.py:71-78`).
LIMB_PAIRS = [
    (0, 1), (0, 2), (1, 3), (2, 4),              # head
    (5, 6), (5, 7), (7, 9), (6, 8), (8, 10),     # arms
    (17, 11), (17, 12),                           # body (fake neck)
    (11, 13), (12, 14), (13, 15), (14, 16),       # legs (absent in CM100)
    (11, 12), (5, 11), (6, 12),                   # body outline
]
_BLUE = (255, 128, 0)
_GRAY = (120, 120, 120)
_RED = (51, 41, 255)
_WHITE = (255, 255, 255)
LIMB_COLORS = [_BLUE] * 4 + [_BLUE] * 5 + [_GRAY] * 6 + [_BLUE] * 3


def smooth_motion(motion: np.ndarray, kernel: int = 11, order: int = 5) -> np.ndarray:
    """Per-joint Savitzky-Golay smoothing (`motion_utils.py:28-34`),
    vectorized over joints/channels instead of the reference's double loop."""
    return savgol_filter(motion, kernel, order, axis=0)


def bandpass_motion(motion: np.ndarray, low: float = 0.4, high: float = 8.0,
                    fs: float = 30.0, order: int = 2) -> np.ndarray:
    """Butterworth band-pass on the motion (ProspectiveCup
    `utils/motion_utils.py:177-192` `filter()`): keeps conducting-frequency
    content, removes drift and jitter."""
    sos = butter(order, [low, high], btype="bandpass", fs=fs, output="sos")
    mean = motion.mean(axis=0, keepdims=True)
    return sosfiltfilt(sos, motion - mean, axis=0) + mean


def norm_motion(motion: np.ndarray, width: float, height: float) -> np.ndarray:
    """Normalize raw pixel keypoints: shoulder width to 1/5, hips centered at
    (0.5, 0.75) (`motion_utils.py:37-52`)."""
    kp = motion / width
    shoulder = np.mean(kp[:, 5, 0] - kp[:, 6, 0])
    kp = kp / (5 * shoulder)
    hip_x = np.mean(kp[:, 11, 0] + kp[:, 12, 0]) / 2
    hip_y = np.mean(kp[:, 11, 1] + kp[:, 12, 1]) / 2
    kp[..., 0] -= hip_x - 0.5
    kp[..., 1] -= hip_y - 0.75
    return kp


def coco_to_cm100(kp: np.ndarray) -> np.ndarray:
    """COCO-17 -> ConductorMotion100-13 (`motion_utils.py:185-186`)."""
    return kp[:, :13, :]


def cm100_to_coco(kp: np.ndarray) -> np.ndarray:
    """CM100-13 -> COCO-17, legs zero-padded (`motion_utils.py:189-192`)."""
    out = np.zeros((kp.shape[0], 17, 2), dtype=kp.dtype)
    out[:, :13, :] = kp
    return out


def render_frame(img, kp: np.ndarray, scores: np.ndarray, hand_trace: np.ndarray):
    """Draw one skeleton frame with fading wrist traces
    (`motion_utils.py:55-141`).  kp: (17, 2) pixels, scores: (17,)."""
    import cv2

    trace_head, trace_end = np.array(_RED, float), np.array(_WHITE, float)
    n_tr = len(hand_trace)
    for i in range(n_tr):
        color = (i / n_tr) * trace_head + (1 - i / n_tr) * trace_end
        for j in range(hand_trace.shape[1]):
            x, y = int(hand_trace[i, j, 0]), int(hand_trace[i, j, 1])
            if x >= 0 and y >= 0:
                cv2.circle(img, (x, y), 2, color, 2)

    part = {
        n: (int(kp[n, 0]), int(kp[n, 1]))
        for n in range(scores.shape[0])
        if scores[n] > 0.4
    }
    for i, (a, b) in enumerate(LIMB_PAIRS):
        if a in part and b in part:
            (x0, y0), (x1, y1) = part[a], part[b]
            mx, my = (x0 + x1) / 2, (y0 + y1) / 2
            length = math.hypot(x0 - x1, y0 - y1)
            angle = math.degrees(math.atan2(y0 - y1, x0 - x1))
            width = scores[a] + scores[b] + 1
            poly = cv2.ellipse2Poly(
                (int(mx), int(my)), (int(length / 2), int(width)), int(angle), 0, 360, 10
            )
            cv2.fillConvexPoly(img, poly, LIMB_COLORS[i])

    for n in (9, 10):  # wrists
        x, y = int(kp[n, 0]), int(kp[n, 1])
        cv2.circle(img, (x, y), 9, _WHITE, 9)
        cv2.circle(img, (x, y), 2, _RED, 2)
        cv2.circle(img, (x, y), 10, _RED, 2)
    return img


def render_motion_video(
    motions: list[np.ndarray],
    save_path: str,
    name: str = "motion",
    *,
    window: int = 600,
    trace_len: int = 30,
    fps: int = 30,
    smooth_kernel: int = 19,
    post_processing: bool = True,
) -> str:
    """Render one or more (T, 13, 2) normalized motions side-by-side into an
    XVID .avi at 30 fps (`motion_utils.py:144-182`).  Returns the video path."""
    import cv2

    os.makedirs(save_path, exist_ok=True)
    video_file = os.path.join(save_path, f"{name}.avi")
    T = motions[0].shape[0]
    writer = cv2.VideoWriter(
        video_file, cv2.VideoWriter_fourcc(*"XVID"), fps,
        (1 + len(motions) * window, window),
    )
    scores = np.zeros((17,))
    scores[:13] = 1.0

    prepared, traces = [], []
    for m in motions:
        m = np.asarray(m, dtype=np.float64) * window
        if post_processing:
            m = smooth_motion(m, kernel=smooth_kernel)
        m17 = cm100_to_coco(m) if m.shape[1] == 13 else m
        trace = np.full((T + trace_len, 2, 2), -1.0)
        trace[trace_len:] = m17[:, 9:11, :]
        prepared.append(m17)
        traces.append(trace)

    for f in range(T):
        frame = np.ones((window, 1, 3), np.uint8) * 255
        for m17, trace in zip(prepared, traces):
            bg = np.ones((window, window, 3), np.uint8) * 255
            img = render_frame(bg, m17[f], scores, trace[f : f + trace_len])
            frame = np.concatenate([frame, img], axis=1)
        writer.write(frame)
    writer.release()
    return video_file


def mux_audio(video_path: str, audio_path: str, out_path: str | None = None) -> str:
    """Attach the source audio to a rendered video (the reference uses
    moviepy/ffmpeg, `visualization.py:144-150`); requires ffmpeg or moviepy —
    returns the video path unchanged (with a note) when neither exists."""
    import shutil
    import subprocess

    out_path = out_path or video_path.rsplit(".", 1)[0] + ".mp4"
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg:
        subprocess.run(
            [ffmpeg, "-y", "-i", video_path, "-i", audio_path,
             "-c:v", "libx264", "-c:a", "aac", "-shortest", out_path],
            check=True, capture_output=True,
        )
        return out_path
    try:
        from moviepy.editor import AudioFileClip, VideoFileClip  # type: ignore

        video = VideoFileClip(video_path).set_audio(AudioFileClip(audio_path))
        video.write_videofile(out_path)
        return out_path
    except ImportError:
        return video_path
