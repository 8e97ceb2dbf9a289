"""Verification run of the PyTorch/CUDA port: decode synthetic captures on the
CUDA card and check physics (the counterpart of the verify skill's
drive_verify.py for the JAX package).

    python3 scripts/drive_verify_torch.py [--device cpu]

Checks: NTSC sync tips ~ -40 IRE, a flat-50 field ~ 50 IRE, the audio
carriers ~ 2.301 / 2.813 MHz; kernel K1 against its plain version on the
card on a framer-locked 4-field batch (the picture and both burst windows,
bit for bit) and `field_finish_batch` there; a dim-2 comb frame; PAL's
sync-region median and its 3.75 MHz pilot.  Prints VERIFY_RESULT: PASS or
FAIL and exits 0 only on PASS.  Imports neither jax nor the JAX package.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..'))


def demod_checks(torch, cfg, device):
    """Sync tip, flat-field and audio carrier levels of a flat-50 NTSC
    field; returns ok."""
    from ld_decode_tpu_torch.models import encode as E
    from ld_decode_tpu_torch.ops import demod as D, filters as F
    samples = E.encode_frames(cfg, 1, E.EncodeSpec(pattern='flat50'))
    bank = F.make_demod_bank(cfg, np.complex64, device=device)
    n = D.stream_len(cfg, 40)
    video, audio = D.demod_stream(
        torch.from_numpy(samples[:n].astype(np.float32)).to(device), bank,
        cfg, 40, 1.0)
    ire = cfg.hztoire(video['demod'].cpu().numpy())
    n_sync = int(np.sum(ire < -35))
    sync = np.median(ire[ire < -35]) if n_sync else float('nan')
    flat = np.median(ire[(ire > 40) & (ire < 60)])
    frac = np.mean((ire > 45) & (ire < 55))
    fl = float(np.median(audio['audio_left'].cpu().numpy())) / 1e6
    fr = float(np.median(audio['audio_right'].cpu().numpy())) / 1e6
    print(f'sync tips: median {sync:.2f} IRE over {n_sync} samples')
    print(f'flat field: median {flat:.2f} IRE, frac in 45..55: {frac:.3f}')
    print(f'audio carriers: L {fl:.4f} MHz  R {fr:.4f} MHz')
    return (-42 < sync < -38 and 48 < flat < 52 and frac > 0.5
            and abs(fl - 2.301136) < 0.01 and abs(fr - 2.812499) < 0.01)


def k1_checks(torch, cfg, device):
    """K1 against its plain version on a framer-locked 4-field batch (the
    picture and the two burst windows of its refinement), then one
    `field_finish_batch` and a dim-2 comb frame; returns ok."""
    from ld_decode_tpu_torch.comb.comb_ntsc import CombConfig, NTSCComb
    from ld_decode_tpu_torch.models import encode as E
    from ld_decode_tpu_torch.ops import filters as F
    from ld_decode_tpu_torch.tbc import cuda_resample as CR
    from ld_decode_tpu_torch.tbc import framer as FR
    from ld_decode_tpu_torch.tbc import fused as FU
    cap = E.encode_frames(cfg, 3, E.EncodeSpec(pattern='bars',
                                               cav_start_frame=900))
    bank = F.make_demod_bank(cfg, np.complex64, device=device)
    batch, nblk = 4, 52
    pitch = int(round(cfg.freq_hz / cfg.sys.fps / 2))
    # a batch started at a raw capture offset is invalid in the device
    # vsync voter: lock onto the field grid with the framer first
    fr = FR.Framer(cfg, bank, capture=cap, batch=1, nblocks=nblk,
                   device=device, graphs=False)
    f0, rs0, _ = fr.readfield(None, 33046)
    rs0 = int(f0.readsample if f0.readsample >= 0 else rs0)
    capt = fr.capture_dev
    starts = FU.pipeline_starts(rs0, 0, batch, pitch, cap.shape[0], cfg,
                                nblk, device=device)
    video, audio1, lld, lc, valid, *_ = FU.pipeline_analyze(
        capt, starts, 1.0, bank, cfg, nblk)
    ok = bool(valid.all())
    lli, llf, _bad = FU._hsync_refine(video, lld.lli, lld.llf, lld.bad, lc,
                                      cfg)
    max_lc, W = FU.max_linecount(cfg), cfg.sys.outlinelen
    worst = 0.0
    for name, data, i_, f_, window in (
            ('picture', video['demod'], lli[:, 1:], llf[:, 1:], {}),
            ('burst window', video['demod_burst'], lli, llf,
             dict(col0=16, ncols=48))):
        got = CR.resample_lines_batch(data, i_, f_, W, max_lc,
                                      float(cfg.linelen), **window)
        want = CR.resample_lines_batch_plain(data, i_, f_, W, max_lc,
                                             float(cfg.linelen), **window)
        d = float((got - want).abs().max())
        worst = max(worst, d)
        print(f'K1 {name} {tuple(got.shape)} vs its plain version: max '
              f'|diff| = {d}')
    ok = ok and worst == 0.0
    launches = CR.resample_lines_batch.launches
    n_audio1 = nblk * bank.a_stage1_keep
    out = FU.field_finish_batch(
        video, audio1, lld.lli, lld.llf, lld.bad, lc,
        torch.zeros(batch, device=device), bank, cfg, n_audio1)
    pics = out['picture'].cpu().numpy()
    print(f'field_finish_batch: picture {pics.shape}, K1 launches '
          f'{CR.resample_lines_batch.launches - launches}')
    ok = ok and pics.shape == (batch, max_lc, W) and pics.max() > 0

    frame = np.zeros((525, 910), np.uint16)
    frame[0::2] = pics[0][:263]
    frame[1::2] = pics[1][:262]
    rgb = NTSCComb(CombConfig(dim=2), device=device).process(frame)
    print(f'2D comb: rgb {rgb.shape}, max {int(rgb.max())}')
    return ok and rgb.shape == (480, 744, 3) and rgb.max() > 0


def pal_checks(torch, device):
    """PAL's sync-region median, flat field and pilot frequency."""
    from ld_decode_tpu_torch.models import encode as E
    from ld_decode_tpu_torch.ops import demod as D, filters as F
    from ld_decode_tpu_torch.utils.params import DecoderConfig
    pcfg = DecoderConfig(system='PAL', freq_mhz=40.0)
    psam = E.encode_frames(pcfg, 1, E.EncodeSpec(pattern='flat50'))
    pbank = F.make_demod_bank(pcfg, np.complex64, device=device)
    n = D.stream_len(pcfg, 40)
    pv, _pa = D.demod_stream(
        torch.from_numpy(psam[:n].astype(np.float32)).to(device), pbank,
        pcfg, 40, 1.0)
    pire = pcfg.hztoire(pv['demod'].cpu().numpy())
    sync = np.median(pire[pire < -35]) if np.any(pire < -35) \
        else float('nan')
    flat = np.median(pire[(pire > 40) & (pire < 60)])
    # the pilot tap's cycle rate by zero-crossing density mid-stream
    pil = pv['demod_pilot'][200_000:240_000].cpu().numpy()
    pil = pil - np.mean(pil)
    zc = np.sum(np.diff(np.signbit(pil)) != 0)
    pilot = zc / 2 * (40.0 / len(pil))
    print(f'PAL sync tips {sync:.2f} IRE, flat {flat:.2f} IRE, pilot '
          f'{pilot:.3f} MHz')
    # PAL's stronger de-emphasis rings across the 4.7 us pulses: bound the
    # sync region's median, not a tip
    return -55 < sync < -40 and 48 < flat < 52 and abs(pilot - 3.75) < 0.05


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--device', default='cuda',
                   help='torch device (default cuda; "cpu" runs the plain '
                        'versions here)')
    args = p.parse_args(argv)
    import torch
    from ld_decode_tpu_torch.utils.device import resolve
    from ld_decode_tpu_torch.utils.params import DecoderConfig
    device = resolve(args.device, hint='--device cpu')
    if device.type == 'cuda':
        print(torch.cuda.get_device_name(device))
    cfg = DecoderConfig(system='NTSC', freq_mhz=40.0)
    ok = demod_checks(torch, cfg, device)
    ok = k1_checks(torch, cfg, device) and ok
    ok = pal_checks(torch, device) and ok
    print('VERIFY_RESULT:', 'PASS' if ok else 'FAIL')
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
