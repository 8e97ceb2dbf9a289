"""The port's devbook (docs/devbook_torch.py) must stay runnable end to end,
as docs/devbook.py is for the JAX package: run it headless on the CPU with
jax and the JAX package blocked, and check it renders every figure; and
without matplotlib (as on the card's machine) it prints its numbers and
skips the figures."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIGURES = ('spectrum.png', 'lines_38_39.png', 'lineloc_diffs.png',
           'raw_frame.png', 'rgb_preview.png')
# block imports by name before the notebook runs (None in sys.modules makes
# an import raise)
RUN = ('import runpy, sys\n'
       'for m in {blocked!r}:\n'
       '    sys.modules[m] = None\n'
       'runpy.run_path({path!r}, run_name="__main__")\n')


def _run(tmp_path, blocked):
    env = dict(os.environ, LDD_DEVBOOK_CPU='1', MPLBACKEND='Agg',
               LDD_DEVBOOK_OUT=str(tmp_path), PYTHONPATH=REPO)
    env.pop('DISPLAY', None)
    code = RUN.format(blocked=('jax', 'ld_decode_tpu') + blocked,
                      path=os.path.join(REPO, 'docs', 'devbook_torch.py'))
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_devbook_torch_runs_and_renders(tmp_path):
    out = _run(tmp_path, ())
    assert 'frame shape: (477750,)' in out and 'devbook done' in out
    for name in FIGURES:
        p = os.path.join(tmp_path, name)
        assert os.path.exists(p) and os.path.getsize(p) > 1000, name


def test_devbook_torch_without_matplotlib(tmp_path):
    out = _run(tmp_path, ('matplotlib', 'matplotlib.pyplot'))
    assert 'skipping the figures' in out and 'figures skipped' in out
    assert 'diff(linelocs) median' in out and 'RGB preview' in out
    assert not [n for n in FIGURES if os.path.exists(tmp_path / n)]
