"""The harness's files and rules, on the CPU.

    python -m pytest ldbench/tests/test_ldbench_harness.py -q
"""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from ldbench import harness

ROOT = harness.ROOT
BENCH = harness.BENCH_DIR
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
JAX = {'jax', 'jaxlib', 'flax', 'ld_decode_tpu'}


def benchmark():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


@pytest.mark.parametrize('cell', [w['name'] for w in
                                  benchmark()['workloads']])
def test_every_cell_resolves(cell):
    c = harness.resolve(cell)
    assert c['config']['name'] == c['workload']['config']
    harness.driver_class(c['traffic']['entry'])
    assert set(c['limits']) == {'lineloc_px', 'lineloc_p99_px',
                                'picture_lsb', 'audio_p99_lsb'}
    names = {m['name'] for m in c['end_to_end']}
    assert names == {'rf_msa_s', 'frame_gap_p99_ms', 'peak_mem_gib',
                     'setup_s'}
    for m in c['per_layer']:
        assert callable(harness.metric_reader(m['name']))
    entry = next(e for e in benchmark()['configs']
                 if e['name'] == c['workload']['config'])
    for k in entry['reduced']:
        assert k in c['config']


def test_names_and_units():
    b = benchmark()
    seen = set()
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        for e in b[group]:
            assert NAME.match(e['name']), e['name']
            assert (group, e['name']) not in seen
            seen.add((group, e['name']))
            if 'unit' in e:
                assert UNIT.match(e['unit']), e['unit']
            for k in ('config', 'traffic'):
                if k in e:
                    assert NAME.match(e[k])
            for k in e.get('reduced', []):
                assert NAME.match(k)
    for m in b['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
    for m in b['per_layer']:
        assert m['moves'] == 'rf_msa_s'
        if m['name'].endswith('_roofline'):
            assert m['unit'] == '%'


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    files = [os.path.join(d, f) for d, _, fs in os.walk(BENCH)
             for f in fs if f.endswith('.py')]
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            assert name.split('.')[0] not in JAX, (path, name)


def _strings(path):
    """The string literals of a module that are not docstrings."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    docs = {id(n.value) for n in ast.walk(tree)
            if isinstance(n, ast.Expr) and isinstance(n.value, ast.Constant)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_reads_none_of_the_older_benches():
    """The harness neither imports bench.py, bench_torch.py or
    chip_smoke.py nor names a file of their results."""
    for d, _, fs in os.walk(BENCH):
        for f in fs:
            if not f.endswith('.py') or f == os.path.basename(__file__):
                continue
            path = os.path.join(d, f)
            for name in _imports(path):
                assert name.split('.')[0] not in (
                    'bench', 'bench_torch', 'chip_smoke'), (path, name)
            for text in _strings(path):
                for word in ('BENCH_', 'BASELINE.json', 'bench_torch',
                             'bench.py', 'MULTICHIP'):
                    assert word not in text, (path, text)


def test_a_run_without_a_card_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    p = subprocess.run([sys.executable, 'ldbench/run.py', '--workload',
                        'ntsc_cav_dd40.decode', '--seed', '1',
                        '--seconds', '1', '--trace', '0'], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


def test_a_run_without_the_program_fails(tmp_path):
    """In a checkout that holds only BENCHMARK.json and the benchmark's
    folder, a run exits nonzero with no result."""
    import shutil
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(BENCH, tmp_path / 'ldbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    p = subprocess.run([sys.executable, 'ldbench/run.py', '--workload',
                        'ntsc_cav_dd40.decode', '--seed', '1',
                        '--seconds', '1', '--trace', '0'], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    """A 2-second window of the first cell on the card: correct, and every
    end-to-end metric present."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    p = subprocess.run([sys.executable, 'ldbench/run.py', '--workload',
                        'ntsc_cav_dd40.decode', '--seed', '987654321',
                        '--seconds', '2', '--trace', '0'], cwd=ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out['correct'] and out['failed'] == 0
    assert set(out['metrics']) == {'rf_msa_s', 'frame_gap_p99_ms',
                                   'peak_mem_gib', 'setup_s'}


def test_the_source_ops_leave_the_busy_union():
    """Device operations launched inside the source's ranges, and every
    operation on their stream, are the source's: the busy union and the
    operations by time leave them out, and an idle gap begun while the
    source made bytes is the loader's."""
    from ldbench import yardstick as Y
    dev = [(0.0, 10.0, 'port_a', 7, 1), (5.0, 15.0, 'source_k', 13, 2),
           (20.0, 30.0, 'source_copy', 13, 3), (40.0, 50.0, 'port_b', 7, 4)]
    host = [(0.0, 100.0, 'ldbench.slice'), (3.0, 17.0, 'ldbench.loader'),
            (4.0, 16.0, 'ldbench.source')]
    launches = [(1.0, 1), (4.5, 2), (30.0, 4)]
    mine, rest = Y.split_source_ops(dev, host, launches)
    assert {d[2] for d in mine} == {'source_k', 'source_copy'}
    assert [d[2] for d in rest] == ['port_a', 'port_b']
    out = Y.slice_summary(rest, host, 0.0, 100.0)
    assert out['busy_s'] == pytest.approx(20e-6)
    assert [n for n, _ in out['device_ops']] == ['port_a', 'port_b']
    assert dict(out['idle_gaps']) == pytest.approx(
        {'ldbench.loader': 30e-6, 'ldbench.slice': 50e-6})


def test_a_trace_without_its_slice_is_refused(monkeypatch):
    from ldbench import yardstick as Y
    monkeypatch.setattr(Y, 'trace_events', lambda prof: (
        [(0.0, 1.0, 'k', 7, 1)], [(0.0, 2.0, 'ldbench.readframe')], []))
    with pytest.raises(RuntimeError):
        harness._summarise(None, Y)


def test_the_audio_carry_runs_on_from_field_to_field():
    """The reference's carries chain from 0 through each field's line
    count; a field that started elsewhere, or after a field that did not
    advance the carry, is named."""
    from ldbench.reference import judge as J
    from ldbench.source.params import DecoderConfig
    cfg = DecoderConfig(system='NTSC', freq_mhz=40.0)
    lcs = [263, 262] * 4
    chain, c = [], 0.0
    for lc in lcs:
        chain.append(c)
        c = J.next_carry(cfg, c, lc)
    fields = [(c, lc, True) for c, lc in zip(chain, lcs)]
    ref, bad = J.audio_carries(cfg, fields)
    assert bad == [] and list(ref) == chain
    assert len(set(chain)) > 2
    reset = [(0.0, lc, True) for lc in lcs]
    assert J.audio_carries(cfg, reset)[1] == list(range(1, len(lcs)))
    held = fields[:3] + [(fields[3][0], lcs[3], False)] + fields[4:]
    assert J.audio_carries(cfg, held)[1] == list(range(4, len(lcs)))
