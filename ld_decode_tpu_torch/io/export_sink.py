"""RGB video output sink of the packaging CLIs.

The PyTorch port's copy of ld_decode_tpu/io/export_sink.py (host only; the
port imports nothing of the JAX package): tests/test_torch_hostcopies.py
holds the two equal.  One place owns the output stream formats
(rgb48le/rgb24 rawvideo, the ffmpeg mux arguments, per-frame image mode).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from typing import Optional

import numpy as np


class VideoSink:
    """ffmpeg .mp4 mux (when available and not forced raw), raw .rgb
    stream, or per-frame .rgb images.

    audio_path: when given at open time, muxed as a second ffmpeg
    input in the same pass (the two-CLI path, where the whole .pcm
    exists up front).  Producers that generate audio DURING the video
    pass instead call `remux_audio` after close().
    """

    def __init__(self, outbase: str, width: int, height: int, fps: str,
                 write8bit: bool = False, audio_path: Optional[str] = None,
                 force_raw: bool = False, write_images: bool = False,
                 quiet_ffmpeg: bool = False):
        self.outbase = outbase
        self.write_images = write_images
        self.nframes = 0
        self._proc = None
        self._f = None
        self._ffmpeg = None if force_raw else shutil.which('ffmpeg')
        if write_images:
            return
        if self._ffmpeg:
            cmd = [self._ffmpeg, '-y', '-f', 'rawvideo', '-pix_fmt',
                   'rgb24' if write8bit else 'rgb48le',
                   '-s', f'{width}x{height}', '-r', fps, '-i', '-']
            if audio_path:
                cmd += ['-f', 's16le', '-ar', '48000', '-ac', '2',
                        '-i', audio_path]
            cmd += ['-flags', '+ildct+ilme', outbase + '.mp4']
            self._proc = subprocess.Popen(
                cmd, stdin=subprocess.PIPE,
                stderr=subprocess.DEVNULL if quiet_ffmpeg else None)
            self._f = self._proc.stdin
        else:
            if not force_raw:
                fmt = 'rgb24' if write8bit else 'rgb48'
                print(f'ffmpeg not found; writing raw {fmt} stream to '
                      f'{outbase}.rgb', file=sys.stderr)
            self._f = open(outbase + '.rgb', 'wb')

    def write(self, frame_rgb: np.ndarray) -> None:
        if self.write_images:      # comb -f: per-frame .rgb files
            with open(f'{self.outbase}_{self.nframes}.rgb', 'wb') as f:
                f.write(np.ascontiguousarray(frame_rgb).tobytes())
        else:
            self._f.write(np.ascontiguousarray(frame_rgb).tobytes())
        self.nframes += 1

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
        if self._proc is not None:
            self._proc.wait()

    def remux_audio(self, audio_path: str) -> None:
        """Stream-copy the video and add the (now complete) audio —
        for producers whose audio is generated during the video pass."""
        if self._proc is None or not os.path.getsize(audio_path):
            return
        tmp = self.outbase + '.mux.mp4'
        r = subprocess.run(
            [self._ffmpeg, '-y', '-i', self.outbase + '.mp4',
             '-f', 's16le', '-ar', '48000', '-ac', '2', '-i', audio_path,
             '-map', '0:v', '-map', '1:a', '-c:v', 'copy', tmp],
            capture_output=True)
        if r.returncode == 0:
            os.replace(tmp, self.outbase + '.mp4')
        else:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            tail = r.stderr.decode(errors='replace')[-400:]
            print(f'audio remux failed; audio left in {audio_path}\n'
                  f'{tail}', file=sys.stderr)
