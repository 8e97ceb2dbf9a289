# %% [markdown]
# # ld-decode-tpu devbook, the PyTorch/CUDA port
#
# The port's counterpart of `docs/devbook.py`: the same cells and the
# same five figures, decoded by `ld_decode_tpu_torch` -- the reference's
# notebook-driven workflow (`lddecode_devbook.ipynb`: decode frames, plot
# `combined[910*38:910*40]`, `np.diff(linelocs)`, raw B&W field images;
# `fft8.py`: capture spectrum QA).
#
# A jupytext percent-format notebook: open it in Jupyter (`jupytext --to
# ipynb docs/devbook_torch.py`), or run it headless (`python
# docs/devbook_torch.py`) to print its numbers and render every figure
# into `docs/devbook_out/torch/` (`LDD_DEVBOOK_OUT` names another
# directory).  It decodes on the CUDA card; `LDD_DEVBOOK_CPU=1` asks for
# the CPU, which is how `tests/test_torch_devbook.py` runs it.  Without
# matplotlib it prints its numbers and says that it skips the figures.
#
# The default input is the synthetic encoder (`models/encode.py`), so the
# notebook runs anywhere; point `CAPTURE` at a real file to reproduce the
# reference workflow.

# %%
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from ld_decode_tpu_torch.models import encode as E
from ld_decode_tpu_torch.ops import filters as F
from ld_decode_tpu_torch.tbc import framer as FR
from ld_decode_tpu_torch.utils import filtertools as FT
from ld_decode_tpu_torch.utils.params import DecoderConfig

DEVICE = 'cpu' if os.environ.get('LDD_DEVBOOK_CPU') else 'cuda'

try:
    import matplotlib
    if not os.environ.get('DISPLAY'):
        matplotlib.use('Agg')
    import matplotlib.pyplot as plt
except ImportError:
    plt = None
    print('matplotlib is not installed: printing the numbers, skipping the '
          'figures')

OUTDIR = os.environ.get('LDD_DEVBOOK_OUT') or os.path.join(
    os.path.dirname(os.path.abspath(__file__)), 'devbook_out', 'torch')
os.makedirs(OUTDIR, exist_ok=True)


def figure(**kw):
    """A new figure and its axes, or (None, None) without matplotlib."""
    return plt.subplots(**kw) if plt is not None else (None, None)


def show(fig, name):
    """Save headless, display interactive; nothing without matplotlib."""
    if fig is None:
        return
    fig.savefig(os.path.join(OUTDIR, name), dpi=110, bbox_inches='tight')
    if matplotlib.get_backend().lower() != 'agg':
        plt.show()
    plt.close(fig)


# %% [markdown]
# ## 1. A capture to work on
#
# `CAPTURE = None` synthesizes a 3-frame NTSC CAV colorbar disc
# (40 MSa/s, like unpacked `.lds` data).  Set it to a path + loader to
# use a real rip, e.g.:
#
# ```python
# from ld_decode_tpu_torch.io import loaders as L
# CAPTURE = ('/captures/ve-snw-cut.lds', L.load_packed_4_40)
# ```

# %%
CAPTURE = None
cfg = DecoderConfig(system='NTSC', freq_mhz=40.0)

if CAPTURE is None:
    samples = E.encode_frames(
        cfg, 3, E.EncodeSpec(pattern='bars', cav_start_frame=1200))
else:
    path, loader = CAPTURE
    with open(path, 'rb') as fd:
        samples = loader(fd, 0, 4_200_000)
    if samples is None:
        raise SystemExit(f'{path}: short read -- need 4.2 M samples '
                         '(~105 ms of 40 MSa/s capture)')
    # signed loaders (.r16) are zero-centred; the Framer recentres them
    # itself, but the spectrum cells below expect unsigned-style data
    if np.issubdtype(np.asarray(samples).dtype, np.signedinteger):
        samples = (np.asarray(samples, np.int32) + 32768).astype(np.uint16)
print(f'{len(samples) / 1e6:.1f} M samples @ {cfg.freq_mhz} MSa/s '
      f'({len(samples) / cfg.freq_mhz / 1e6:.2f} s of disc), decoding on '
      f'{DEVICE}')

# %% [markdown]
# ## 2. Capture QA: RF spectrum (the `fft8.py` analog)
#
# Healthy NTSC RF shows the video FM carrier hump at 7.6-9.3 MHz and the
# two analog audio carriers at 2.301/2.812 MHz.

# %%
freqs, psd = FT.capture_spectrum(samples[:262144].astype(np.float64),
                                 freq_mhz=cfg.freq_mhz)
db = 10 * np.log10(np.maximum(psd, 1e-30))
for f_mhz, label in [(2.301136, 'audio L'), (2.812499, 'audio R'),
                     (8.1, 'video ire0')]:
    k = int(np.argmin(np.abs(freqs - f_mhz)))
    print(f'{label:10s} {f_mhz:.6f} MHz: {db[k]:.1f} dB')
fig, ax = figure(figsize=(9, 3.2))
if ax is not None:
    ax.plot(freqs, db, lw=0.7)
    for f_mhz, label in [(2.301136, 'audio L'), (2.812499, 'audio R'),
                         (8.1, 'video ire0')]:
        ax.axvline(f_mhz, color='tab:red', ls=':', lw=0.8)
        ax.text(f_mhz, ax.get_ylim()[1], label, rotation=90,
                va='top', ha='right', fontsize=7)
    ax.set(xlabel='MHz', ylabel='dB', title='capture spectrum',
           xlim=(0, cfg.freq_mhz / 2))
show(fig, 'spectrum.png')
print('peak-to-background:',
      f'{FT.peak_to_background_db(samples[:262144].astype(np.float64), cfg.freq_mhz):.1f} dB')

# %% [markdown]
# ## 3. Decode one frame
#
# `Framer.readframe` is the whole pipeline: batched overlap-save FM demod
# -> sync/vsync -> line numbering -> hsync+burst refinement -> TBC resample
# to the 910x4fsc grid (kernel K1 on the card) -> audio chase.  `batch=1`
# decodes field by field, as the JAX package's default Framer does.

# %%
bank = F.make_demod_bank(cfg, np.complex64, device=DEVICE)
framer = FR.Framer(cfg, bank, capture=samples, batch=1, device=DEVICE)
combined, audio, nextsample, fields = framer.readframe(None, 33046, True)
print('frame shape:', combined.shape, ' next sample:', nextsample,
      ' VBI:', framer.vbi)

# %% [markdown]
# ## 4. The reference's three regression plots
#
# (a) two raw TBC'd lines (`combined[910*38:910*40]`) -- sync tip / burst /
# active video levels; (b) `np.diff(linelocs)` -- must sit at ~2543.4
# samples/line with no steps; (c) the raw B&W field.

# %%
w = cfg.sys.outlinelen
lines = combined[38 * w:40 * w]
print(f'lines 38-39: min {lines.min()}, median {int(np.median(lines))}, '
      f'max {lines.max()}')
fig, ax = figure(figsize=(9, 3))
if ax is not None:
    ax.plot(lines, lw=0.7)
    ax.set(title='TBC output, lines 38-39 (uint16)', xlabel='sample')
show(fig, 'lines_38_39.png')

# %%
for i, fr in enumerate(fields[:2]):
    if fr is not None and fr.linelocs is not None:
        d = np.diff(fr.linelocs)
        print(f'field {i}: diff(linelocs) median {np.median(d):.3f}, '
              f'range {d.min():.3f}..{d.max():.3f} samples/line')
fig, axes = figure(ncols=2, figsize=(10, 3))
if axes is not None:
    for i, fr in enumerate(fields[:2]):
        if fr is not None and fr.linelocs is not None:
            axes[i].plot(np.diff(fr.linelocs), lw=0.8)
            axes[i].set(title=f'field {i}: diff(linelocs)',
                        xlabel='line', ylabel='samples/line')
show(fig, 'lineloc_diffs.png')

# %%
fig, ax = figure(figsize=(8, 5))
if ax is not None:
    ax.imshow(combined.reshape(-1, w), cmap='gray', aspect=w / 525 / 1.4,
              vmin=0x0400, vmax=0xc800)
    ax.set(title='raw interlaced frame (B&W, pre-comb)')
show(fig, 'raw_frame.png')

# %% [markdown]
# ## 5. Comb -> color preview
#
# The 3D comb needs +-1-frame context; a single repeated frame is exact for
# it (no motion), which is also what `ldview_torch.py` does.

# %%
from ld_decode_tpu_torch.comb.comb_ntsc import CombConfig, NTSCComb

comb = NTSCComb(CombConfig(dim=2), device=DEVICE)
rgb = comb.process(combined)
while rgb is None:                      # warm the ring buffer
    rgb = comb.process(combined)
rgb8 = (np.asarray(rgb, np.float32) / 257.0).clip(0, 255).astype(np.uint8)
print('RGB preview:', rgb8.shape, 'mean per channel',
      np.round(rgb8.reshape(-1, 3).mean(0), 1))
fig, ax = figure(figsize=(8, 5))
if ax is not None:
    ax.imshow(rgb8, aspect=rgb8.shape[1] / rgb8.shape[0] / 1.33)
    ax.set(title='2D comb RGB preview')
show(fig, 'rgb_preview.png')

# %% [markdown]
# ## 6. Where to go from here
#
# * filter response plots: `ld_decode_tpu_torch.utils.filtertools.plot_filter`
# * seek experiments: `ld_decode_tpu_torch.tbc.framer.findframe`
# * the card: `python3 chip_smoke.py`, `scripts/profile_torch.py`, `PERF.md`
# * parity against the JAX package: `tests/test_torch_*.py`

# %%
print('devbook done;', 'figures in ' + OUTDIR if plt is not None
      else 'figures skipped (no matplotlib)')
