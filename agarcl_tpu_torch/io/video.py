"""Video recording without OpenCV (counterpart of io/video.py).

The reference writes MJPG-in-AVI through cv2.VideoWriter
(gym_agario/AgarioEnv.py:372-404). This writes the same format, Motion-JPEG
frames in a minimal RIFF/AVI container, with PIL's JPEG encoder (imported
when a video is written), or an animated GIF when PIL cannot write JPEG.
"""

from __future__ import annotations

import io
import struct
from typing import List

import numpy as np


def _jpeg_bytes(frame: np.ndarray, quality: int = 90) -> bytes:
    from PIL import Image
    img = Image.fromarray(np.ascontiguousarray(frame))
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def write_mjpeg_avi(path: str, frames: List[np.ndarray],
                    fps: float = 60.0) -> None:
    """Write RGB uint8 frames as an MJPG AVI (the reference's format)."""
    if not frames:
        raise ValueError("no frames")
    h, w = frames[0].shape[:2]
    jpegs = [_jpeg_bytes(f) for f in frames]

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        pad = b"\x00" if len(payload) % 2 else b""
        return fourcc + struct.pack("<I", len(payload)) + payload + pad

    # BITMAPINFOHEADER with the 'MJPG' compression code
    strf = struct.pack("<IiiHHIIiiii", 40, w, h, 1, 24, 0x47504A4D,
                       w * h * 3, 0, 0, 0, 0)
    # AVISTREAMHEADER: flags, priority, language, initial_frames, scale,
    # rate, start, length, suggested_buf, quality(-1), sample_size, rcFrame
    strh = (b"vids" + b"MJPG"
            + struct.pack("<IHHIIIIIIiI4H", 0, 0, 0, 0, 1, int(fps), 0,
                          len(jpegs), w * h * 3, -1, 0, 0, 0, w, h))
    strl = chunk(b"LIST", b"strl" + chunk(b"strh", strh)
                 + chunk(b"strf", strf))
    avih = struct.pack("<IIIIIIIIIIIIII", int(1e6 / fps), 0, 0, 0x10,
                       len(jpegs), 0, 1, w * h * 3, w, h, 0, 0, 0, 0)
    hdrl = chunk(b"LIST", b"hdrl" + chunk(b"avih", avih) + strl)

    movi_payload = b"movi"
    offsets = []
    for j in jpegs:
        offsets.append(len(movi_payload) - 4)
        movi_payload += chunk(b"00dc", j)
    movi = chunk(b"LIST", movi_payload)

    idx = b""
    for off, j in zip(offsets, jpegs):
        idx += b"00dc" + struct.pack("<III", 0x10, off + 4, len(j))
    idx1 = chunk(b"idx1", idx)

    riff_payload = b"AVI " + hdrl + movi + idx1
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff_payload)) + riff_payload)


def write_gif(path: str, frames: List[np.ndarray], fps: float = 30.0) -> None:
    from PIL import Image
    imgs = [Image.fromarray(np.ascontiguousarray(f)) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)


def write_video(path: str, frames: List[np.ndarray],
                fps: float = 60.0) -> None:
    """Frames (RGB, or one channel repeated to three) to `path`: a GIF for a
    .gif path, else an MJPG AVI (a GIF beside it if that fails)."""
    frames = [np.asarray(f, dtype=np.uint8) for f in frames]
    frames = [f if f.ndim == 3 and f.shape[2] == 3
              else np.repeat(f[..., :1], 3, axis=2) for f in frames]
    try:
        if path.lower().endswith(".gif"):
            write_gif(path, frames, fps)
        else:
            write_mjpeg_avi(path, frames, fps)
    except Exception:
        write_gif(path + ".gif", frames, fps)
