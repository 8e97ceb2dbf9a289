"""PyTorch port: it imports neither jax nor the JAX package, runs with both
blocked, and its chip smoke script refuses to run without a CUDA card."""

import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = [os.path.join(d, f)
              for d, _, fs in os.walk(os.path.join(ROOT, 'ld_decode_tpu_torch'))
              for f in fs if f.endswith('.py')] \
    + [os.path.join(ROOT, f) for f in ('lddecode_torch.py',
                                       'ldchain_torch.py', 'ldexport_torch.py',
                                       'ldview_torch.py', 'chip_smoke.py')]
FORBIDDEN = re.compile(
    r'^\s*(import\s+jax\b|from\s+jax\b|import\s+ld_decode_tpu\b(?!_torch)'
    r'|from\s+ld_decode_tpu\b(?!_torch))', re.M)


def test_port_sources_import_no_jax():
    assert len(PORT_FILES) > 25
    names = {os.path.relpath(p, ROOT) for p in PORT_FILES}
    assert {'ldchain_torch.py', 'ld_decode_tpu_torch/comb/optflow.py',
            'ld_decode_tpu_torch/comb/comb_ntsc.py',
            'ld_decode_tpu_torch/comb/batch.py',
            'ld_decode_tpu_torch/ops/gather.py',
            'ld_decode_tpu_torch/ops/cuda_gather.py',
            'ld_decode_tpu_torch/audio/cx.py',
            'ld_decode_tpu_torch/io/export_sink.py',
            'ld_decode_tpu_torch/tbc/pal.py',
            'ld_decode_tpu_torch/comb/comb_pal.py',
            'ld_decode_tpu_torch/audio/efm.py',
            'ld_decode_tpu_torch/audio/circ.py',
            'ld_decode_tpu_torch/audio/subcode.py',
            'ld_decode_tpu_torch/audio/cuda_cx.py',
            'ld_decode_tpu_torch/audio/downscale.py',
            'ldexport_torch.py', 'ldview_torch.py',
            'ld_decode_tpu_torch/models/nn_comb.py',
            'ld_decode_tpu_torch/tape/vhs.py',
            'ld_decode_tpu_torch/vbi/iec60857.py',
            'ld_decode_tpu_torch/utils/fdls.py',
            'ld_decode_tpu_torch/utils/filtertools.py',
            'ld_decode_tpu_torch/utils/filtermaker.py',
            'ld_decode_tpu_torch/parallel/mesh.py',
            'ld_decode_tpu_torch/io/native_unpack.py',
            'ld_decode_tpu_torch/utils/native_build.py',
            'ld_decode_tpu_torch/tbc/codec.py',
            'ld_decode_tpu_torch/tbc/native_codec.py',
            'ld_decode_tpu_torch/comb/comb_pal_legacy.py',
            'ld_decode_tpu_torch/utils/graphs.py'} <= names
    for path in PORT_FILES:
        with open(path) as f:
            m = FORBIDDEN.search(f.read())
        assert m is None, f'{path}: {m.group(0).strip()}'


BLOCKED = r'''
import sys
sys.modules['jax'] = None            # any import of jax now raises
sys.modules['ld_decode_tpu'] = None  # nor may the JAX package load
import numpy as np
import torch
import lddecode_torch
import ldchain_torch
import ldexport_torch
import ldview_torch
from ld_decode_tpu_torch.audio import circ, cuda_cx, cx, downscale, efm, subcode
from ld_decode_tpu_torch.comb import batch, comb_ntsc, comb_pal, optflow
from ld_decode_tpu_torch.io import export_sink
from ld_decode_tpu_torch.models import encode as E
from ld_decode_tpu_torch.ops import cuda_gather
from ld_decode_tpu_torch.ops import demod as D, filters as F
from ld_decode_tpu_torch.tbc import cuda_resample as CR, framer, fused, pal
from ld_decode_tpu_torch.utils.params import DecoderConfig
cfg = DecoderConfig()
cap = E.encode_frames(cfg, 1, E.EncodeSpec(pattern='flat50'))
n = D.stream_len(cfg, 12)
video, audio = D.demod_stream(torch.from_numpy(cap[:n].astype(np.float32)),
                              F.make_demod_bank(cfg, device='cpu'), cfg,
                              12, 1.0)
ire = cfg.hztoire(video['demod'].numpy())
assert -42 < np.median(ire[ire < -35]) < -38          # sync tips
assert 48 < np.median(ire[(ire > 40) & (ire < 60)]) < 52
lli = torch.tensor([[1000 + 2542 * k for k in range(6)]], dtype=torch.int32)
llf = torch.zeros((1, 6))
out = CR.resample_lines_batch(video['demod'][None].contiguous(), lli, llf,
                              910, 5, 2542.0)
assert out.shape == (1, 5, 910) and torch.isfinite(out).all()
assert CR.resample_lines_batch.launches == 0
yy, xx = np.mgrid[0:63, 0:210].astype(np.float32)
img = 1000 * np.sin(xx / 5) * np.cos(yy / 7) + 5000
flow = optflow.calc_optical_flow_farneback(img, np.roll(img, 1, axis=1),
                                           device='cpu')
assert flow.shape == (63, 210, 2) and torch.isfinite(flow).all()
assert abs(float(flow[20:40, 40:160, 0].median()) - 1) < 0.1
assert cuda_gather.take_along_axis.launches == 0
# PAL: the pilot pass on a synthetic 3.75 MHz pilot, the comb on a grey frame
t = np.arange(2560 * 8)
pilot = torch.from_numpy((2e5 * np.sin(2 * np.pi * t * 3.75 / 40)
                          ).astype(np.float32))[None]
pli = torch.tensor([[3000 + 2560 * k for k in range(6)]], dtype=torch.int32)
li, lf = pal.refine_pilot(pilot, torch.zeros_like(pilot), pli,
                          torch.zeros((1, 6)), 2560, 40.0)
assert li.shape == (1, 6) and torch.isfinite(lf).all()
assert (lf != 0).any()
rgb, ang = comb_pal.comb_pal_frame(
    torch.full((625, 1135), 20000, dtype=torch.int32),
    comb_pal.CombPALConfig(dim=2))
assert rgb.shape == (576, 1135, 3) and int(rgb[300, 500].min()) > 5000
assert int(rgb[300, 500].max() - rgb[300, 500].min()) == 0
q = subcode.encode_q_position(1, 1, 10, 20)
assert subcode.decode_q(q) is not None
assert efm.EFM_DECODE[efm.EFM_CODES[77]] == 77
assert circ.circ_encode(np.zeros((4, 24), np.uint8)).shape[1] == 32
# the streaming NTSC comb and file-level CX (K3's plain version on the CPU)
sc = comb_ntsc.NTSCComb(comb_ntsc.CombConfig(dim=2, debug2d=False),
                        device='cpu')
out = sc.process(np.full(525 * 910, 20000, np.uint16))
assert out.shape == (480, 744, 3) and out.dtype == np.uint16
fast, slow, ok = cx.envelope_followers_blocked(
    np.full(40000, 500.0), core=4096, warm=40000, device='cpu')
assert ok and fast.shape == (40000,) and abs(float(fast[-1]) - 500) < 1
assert cuda_cx.envelope_lanes.launches == 0
# the NN comb, the tape decode and the last host copies
from ld_decode_tpu_torch.models import nn_comb
from ld_decode_tpu_torch.tape import vhs
from ld_decode_tpu_torch.utils import fdls, filtermaker, filtertools
from ld_decode_tpu_torch.vbi import iec60857
g = torch.Generator().manual_seed(0)
inp, clp, *_ = nn_comb.synth_batch(g, 1, 16, 64)
with torch.no_grad():
    assert nn_comb.NNComb((4, 4), g)(inp).shape == (1, 16, 64)
vcfg = vhs.vhs_config()
nv = D.stream_len(vcfg, 4)
tape = torch.from_numpy(E.encode_frames(vcfg, 1, E.EncodeSpec(
    pattern='flat50'))[:nv].astype(np.float32))
vid, aud = vhs.decode_vhs(tape, vhs.make_vhs_bank(vcfg, device='cpu'), vcfg,
                          4)
assert vid['luma'].dtype == torch.int32 and vid['luma'].shape[0] > 0
assert len(filtermaker.design_inventory()) >= 17
assert filtertools.todb(np.ones(4)).max() == 0.0
assert len(fdls.fdls_from_filter([0.5, 0.5], [1.0], 0, 1)[0]) == 2
assert iec60857.interpret_iec60857(0, 0xF80123, 0xF80123).disc_type == 'cav'
# the loaders' C++ unpack (built with g++) and the mesh in a 1-rank world
from ld_decode_tpu_torch.io import loaders, native_unpack
from ld_decode_tpu_torch.utils import native_build
from ld_decode_tpu_torch.parallel import mesh as M
s10 = np.arange(4000) % 1024
assert native_unpack.available() and loaders.unpack_route() == 'native'
assert (native_unpack.unpack_4_40(loaders.pack_data_4_40(s10), 3990, 2)
        == s10[2:3992]).all()
import torch.distributed as dist
dist.init_process_group('gloo', store=dist.HashStore(), rank=0, world_size=1)
mesh = M.make_mesh(device='cpu')
assert (mesh.dp, mesh.sp, mesh.backend) == (1, 1, 'gloo')
comb3 = M.build_sharded_comb3d(comb_ntsc.CombConfig(dim=3), mesh, 1)
assert comb3(torch.full((1, 525, 910), 20000, dtype=torch.int32)).shape \
    == (1, 480, 910, 3)
scfg = DecoderConfig(blocklen=2048, blockcut=128, blockcut_end=32)
step = M.build_sharded_demod(scfg, F.make_demod_bank(scfg, device='cpu'),
                             mesh, 4, 1)
dm, pidx, pval = step(torch.from_numpy(
    cap[:4 * scfg.block_keep].astype(np.float32))[None], 1.0)
assert dm.shape == (1, 4 * scfg.block_keep) and pidx.shape[0] == 1
dist.destroy_process_group()
# the transport codec (native decoder built with g++) and the legacy comb
from ld_decode_tpu_torch.tbc import codec, native_codec
from ld_decode_tpu_torch.comb import comb_pal_legacy as legacy
img = (np.arange(48 * 64).reshape(48, 64) * 37 % 65536).astype(np.int32)
pay = {k: v.numpy() for k, v in codec.encode_image_payload(
    torch.from_numpy(img)[None], 2).items()}
assert native_codec.route() == 'native'
dec, route = codec.decode_payload(
    pay['tab'][0].view(np.uint16), pay['dense'].view(np.uint16),
    pay['dense_q'].view(np.uint16), (48, 64), 2, False,
    int(pay['rows2'][0, 0]))
assert route == 'native' and (dec == img).all()
rgb = legacy.LegacyPALComb(legacy.LegacyPALConfig(), device='cpu').process(
    np.full((610, 1052), 20000, np.uint16))
assert rgb.shape == (576, 974, 3) and rgb.dtype == np.uint16
# the graph cache's static-buffer protocol, emulated on the CPU
from ld_decode_tpu_torch.utils import graphs
cache = graphs.GraphCache('cpu', 'emulate')
outs = [cache('k', lambda x: x + 1, (torch.full((2,), float(v)),))
        for v in range(3)]
assert cache.counts == {'eager_warmups': 1, 'captures': 1, 'replays': 2}
assert float(outs[1][0]) == float(outs[2][0]) == 3.0
assert not [m for m, mod in sys.modules.items() if mod is not None
            and (m in ('jax', 'ld_decode_tpu')
                 or m.startswith(('jax.', 'ld_decode_tpu.')))]
print('PORT_OK')
'''


def test_port_runs_with_jax_blocked():
    proc = subprocess.run([sys.executable, '-c', BLOCKED], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'PORT_OK' in proc.stdout


def _no_result(proc):
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    the script exits nonzero and prints no result."""
    shutil.copy(os.path.join(ROOT, 'chip_smoke.py'), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env=env)
    _no_result(proc)


def test_chip_smoke_needs_a_card():
    """Without a CUDA device the script exits nonzero, no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: chip_smoke.py would run')
    proc = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    _no_result(proc)
    assert 'no CUDA device' in proc.stdout
