"""Tensor parallelism of the port on the CPU (``--model_parallel``), in real
gloo groups of 2 and 4 ranks (``torch_port_dp.Group``, one of each per
module); each job lays its group out with ``parallel.make_mesh(None, k)``.

* (a) ``tp_param_specs`` names the leaves JAX's ``tp_param_specs`` shards on
  an 8-device CPU mesh, on the same (flax) axis, at the default ``Config()``
  widths for k = 2 and 4, for the stock cell, the fast cell and the 'cb'
  encoder; ``shard_params_tp`` keeps ``1/k`` of each on every rank, the
  block JAX's ``shard_params_tp`` places on that model coordinate.
* (b) One and two acoustic steps, scanned and hoisted, remat on, with k=2
  on 2 ranks and 2 x 2 on 4 ranks (B=4): in float64, with every random
  stream on, against the port's one-process step (losses within 1e-10
  relative, each gathered gradient within 1e-9 of its leaf's norm); in
  float32 against the JAX ``train_step`` on the same global batch, at the
  tolerances of ``test_torch_port_parallel.py``.  Each rank holds ``1/k`` of the
  sharded leaves and of their Adam moments.
* (c) A rank's step does less arithmetic than one process's at the same
  local batch (``torch.utils.flop_counter``).
* (d) The global-norm clip on slices equals one process's when it engages.
* (e) The vocoder GAN step with ``--model_parallel 2`` on 2 ranks is the
  one-process step bit for bit.
* (f) ``train_acoustic --num_devices 2 --model_parallel 2`` writes a
  gathered checkpoint that a one-process run resumes, and resumes a
  one-process run's; world rank 0 alone writes each checkpoint.
"""

import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch

import test_torch_port_acoustic_train as AT
import test_torch_port_gan_step as GT
import torch_port_dp as DP
from test_torch_port_parallel import _check_jax, _global_acoustic_batch
from torch_port_common import few_threads  # noqa: F401
from torch_port_common import (_acoustic_shapes, acoustic_cfg_pair, acoustic_tree,
                               small_cfg, vocoder_batch, vocoder_cfg_pair, write_npy_corpus)
from transtacos_retunegan_tpu.config import Config as JaxConfig
from transtacos_retunegan_tpu.parallel import make_mesh as jax_make_mesh
from transtacos_retunegan_tpu.parallel import tp_param_specs as jax_tp_param_specs
from transtacos_retunegan_tpu_torch.config import Config as PortConfig
from transtacos_retunegan_tpu_torch.models.acoustic import Tacotron
from transtacos_retunegan_tpu_torch.parallel import Shard, shard_params_tp, tp_param_specs
from transtacos_retunegan_tpu_torch.train import train_acoustic as ta
from transtacos_retunegan_tpu_torch import weights
from transtacos_retunegan_tpu_torch.weights import flax_layout

pytestmark = pytest.mark.usefixtures('few_threads')


@pytest.fixture(scope='module')
def groups():
    """Both groups, started together (their ranks import in parallel)."""
    started = {n: DP.Group(n) for n in (2, 4)}
    yield started
    for g in started.values():
        g.close()


# ---------------------------------------------------------------------------
# (a) the sharded leaves are JAX's
# ---------------------------------------------------------------------------

VARIANTS = {'sa': {}, 'fast_cell': {'fast_cell': True},
            'cb': {'encoder_type': 'cb', 'embed_depth': 256}}


def _full_cfgs(variant):
    return tuple(dataclasses.replace(c, acoustic=dataclasses.replace(
        c.acoustic, **VARIANTS[variant])) for c in (JaxConfig(), PortConfig()))


@pytest.mark.parametrize('k', [2, 4])
@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_sharded_leaves_are_jax_s(variant, k):
    """The same flax names on the same flax axis as JAX's ``tp_param_specs``
    on a (8/k, k) mesh; each rank of ``shard_params_tp`` holds its ``1/k``
    of them (37 leaves of 4,161,536 elements for the stock model, so
    8,354,139 of its 10,434,907 parameters per rank at k=2)."""
    jcfg, pcfg = _full_cfgs(variant)
    params, _ = _acoustic_shapes(jcfg)
    specs = jax_tp_param_specs(params, jax_make_mesh(8, model_parallel=k))
    want = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
        if 'model' in tuple(spec):
            want['/'.join(str(getattr(p, 'key', p)) for p in path)] = tuple(spec).index('model')
    model = Tacotron(pcfg)
    got = {}
    for name, axis in tp_param_specs(model, k).items():
        path, perm = flax_layout(model, name, model.get_parameter(name).dim())
        got[path] = axis if perm is None else perm[axis]
    assert got == want
    sizes = {n: p.numel() for n, p in model.named_parameters()}
    total = sum(sizes.values())
    split = sum(sizes[n] for n in tp_param_specs(model, k))
    if variant == 'sa':
        assert (len(got), split, total) == (37, 4_161_536, 10_434_907)
    for r in range(k):
        held = Tacotron(pcfg)
        shard_params_tp(Shard(0, 1, r, k), held)
        assert sum(p.numel() for p in held.parameters()) == total - split + split // k
    if variant == 'sa' and k == 2:
        assert total - split // 2 == 8_354_139


@pytest.mark.parametrize('k', [2, 4])
def test_slices_are_jax_s(k):
    """``weights.from_flax`` of a JAX tree then ``shard_params_tp`` at model
    coordinate m gives the block that JAX's ``shard_params_tp`` places on
    the devices of mesh column m, for every sharded leaf (the small test
    widths, where the decoder cell's leaves are sharded)."""
    from transtacos_retunegan_tpu.parallel import shard_params_tp as jax_shard_params_tp
    jcfg, pcfg = acoustic_cfg_pair()
    tree = acoustic_tree(jcfg)
    mesh = jax_make_mesh(8, model_parallel=k)
    column = {d: m for row in mesh.devices for m, d in enumerate(row)}
    placed = jax_shard_params_tp(mesh, tree)
    for m in range(k):
        model = weights.load_flax(Tacotron(pcfg), tree)
        shard_params_tp(Shard(0, 1, m, k), model)
        names = tp_param_specs(Tacotron(pcfg), k)
        assert names
        for name in names:
            path, perm = flax_layout(model, name, model.get_parameter(name).dim())
            leaf = placed
            for key in path.split('/'):
                leaf = leaf[key]
            block = next(np.asarray(s.data) for s in leaf.addressable_shards
                         if column[s.device] == m)
            got = model.get_parameter(name).detach().numpy()
            np.testing.assert_array_equal(got, block if perm is None else block.transpose(perm),
                                          err_msg=name)


# ---------------------------------------------------------------------------
# (b), (c) acoustic steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def jax_step():
    """The JAX ``train_step`` on the B=4 batch at step 4000 with its
    dropouts and noises intercepted (``test_torch_port_parallel.py``'s
    comparison), compiled once per module; at that step the teacher-forcing
    ratio is 1, so the hoisted step computes the same function."""
    jcfg, _ = acoustic_cfg_pair(batch_size=4)
    tree = acoustic_tree(jcfg)
    return AT.jax_step(jcfg, False)(AT._jax_state(jcfg, tree, 4000),
                                    AT._jnp(_global_acoustic_batch(jcfg)),
                                    jax.random.PRNGKey(11))


@pytest.mark.parametrize('ranks', [2, 4])
@pytest.mark.parametrize('case', ['scanned', 'hoisted'])
def test_acoustic_steps_under_tensor_parallelism(groups, jax_step, case, ranks):
    """k=2 on 2 ranks, or 2 data shards x 2 on 4 ranks.  float64, every
    stream on, two steps: losses within 1e-10 relative and each whole
    gradient within 1e-9 of its leaf's norm of one process's (plus 1e-15 of
    the global norm, for the attention key biases, whose gradient is 0 in
    exact arithmetic), the parameters after them within 1e-12 and the
    summaries' whole gradient norms within 1e-9; each rank holds 1/2 of the
    sharded leaves (the decoder cell's GRUs and input projection at these
    widths) and of their moments.  float32, one step without draws: the
    JAX ``train_step``'s losses, gradients and updates
    (``test_torch_port_parallel._check_jax``)."""
    hoisted = case == 'hoisted'
    jcfg, pcfg = acoustic_cfg_pair(batch_size=4)
    tree = acoustic_tree(jcfg)
    batch = _global_acoustic_batch(jcfg)
    batch2 = {k: (v[::-1].copy() if v.ndim else v) for k, v in batch.items()}
    g = groups[ranks]

    args = (pcfg, tree, None, [batch, batch2], 4000, hoisted)
    f64 = (None, torch.float64, (5, 6, 7))          # keep, dtype, seeds
    ref = DP.tp_acoustic_steps(*args, 1, *f64)
    got = g.run(DP.tp_acoustic_steps, *args, 2, *f64)
    for r in got[1:]:
        for name, v in got[0]['params'].items():
            np.testing.assert_array_equal(r['params'][name], v, err_msg=name)
    out = got[0]
    for s_ref, s_tp in zip(ref['steps'], out['steps']):
        for k, v in s_ref['losses'].items():
            np.testing.assert_allclose(s_tp['losses'][k], v, rtol=1e-10, atol=0, err_msg=k)
        gnorm = s_ref['losses']['grad_norm']
        for name, gr in s_ref['grads'].items():
            diff = float(np.abs(s_tp['grads'][name] - gr).max())
            assert diff <= 1e-9 * float(np.linalg.norm(gr)) + 1e-15 * gnorm, (name, diff)
    for name, v in ref['params'].items():
        np.testing.assert_allclose(out['params'][name], v, rtol=0, atol=1e-12, err_msg=name)
    for name, v in ref['grad_norms'].items():
        assert out['grad_norms'][name] == pytest.approx(v, rel=1e-9, abs=1e-15), name

    split = sum(ref['params'][n].size for n in out['sharded'])
    total = sum(v.size for v in ref['params'].values())
    assert out['sharded'] and all(n.startswith('decoder_cell.') for n in out['sharded'])
    assert out['held'] == total - split // 2 and ref['held'] == total
    assert out['moments'] == 2 * (total - split // 2) and ref['moments'] == 2 * total

    jnew, jlosses = jax_step
    f32 = g.run(DP.tp_acoustic_steps, pcfg, tree, None, [batch], 4000, hoisted, 2)
    _check_jax(pcfg, dict(f32[0]['steps'][0], params=f32[0]['params'],
                          buffers=f32[0]['buffers']), jnew, jlosses)


def test_a_rank_computes_its_slice_only(groups):
    """One hoisted step at the default ``Config()`` widths (B=1, 8 decode
    steps) with k=2 on 2 ranks: each rank's FLOPs are under 0.9 of one
    process's on the same rows.  At the small test widths the sharded
    matmuls (the decoder cell's alone: the posnet and attention heads fall
    under JAX's 4,096-element floor) are 15% of the step's FLOPs, which
    leaves a ratio of 0.925, so the count is taken at the default widths,
    where every one of the 37 leaves is sharded."""
    _, pcfg = _full_cfgs('sa')
    jb = _global_acoustic_batch(small_cfg(JaxConfig))
    batch = {k: (v[:1] if v.ndim else v) for k, v in jb.items()}
    ref = DP.tp_step_flops(pcfg, batch, 1)
    got = groups[2].run(DP.tp_step_flops, pcfg, batch, 2)
    assert got[0] == got[1]
    assert got[0] < 0.9 * ref, (got[0], ref)


@pytest.mark.parametrize('ranks', [2, 4])
def test_clip_by_the_whole_norm(groups, ranks):
    """Gradients of three sharded and two replicated leaves whose norm is
    4x the clip: the norm of the slices over the model group and the
    clipped whole gradients equal one process's (float64, 1e-12)."""
    rng = np.random.RandomState(4)
    grads = [rng.randn(*s) for s in [(8, 6), (6,), (4, 8), (3, 5, 4), (7,)]]
    axes = {0: 0, 2: 1, 3: 2}
    scale = 4.0 / np.sqrt(sum(float((g * g).sum()) for g in grads))
    grads = [g * scale for g in grads]
    norm, clipped = DP.tp_clip(grads, axes, 1, 1.0)
    assert norm == pytest.approx(4.0, rel=1e-12)
    for r_norm, r_clipped in groups[ranks].run(DP.tp_clip, grads, axes, 2, 1.0):
        assert r_norm == pytest.approx(norm, rel=1e-12, abs=0)
        for a, b in zip(r_clipped, clipped):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_a_new_group_gets_a_new_layout(groups):
    """After ``make_mesh`` the ranks leave the group and join new ones,
    first with their ranks swapped: ``current_shard()`` is the new group's
    rank until ``make_mesh`` is called again, and that call lays out the
    new group with live model groups (never the old layout)."""
    ports = {DP.free_port()}
    while len(ports) < 2:
        ports.add(DP.free_port())
    got = groups[2].run(DP.regroup, sorted(ports))
    for r, seen in enumerate(got):
        assert seen == [((1 - r, 2, 0, 1), (0, 1, 1 - r, 2), 1.0),
                        ((r, 2, 0, 1), (0, 1, r, 2), 1.0)]


# ---------------------------------------------------------------------------
# (e) the vocoder replicates
# ---------------------------------------------------------------------------

def test_vocoder_step_is_the_one_process_step(groups):
    """``--model_parallel 2`` on 2 ranks is one data shard: both ranks load
    the global batch and take the one-process GAN step, bit for bit (the
    reference at the ranks' one intra-op thread), over two steps."""
    _, pcfg = vocoder_cfg_pair(**GT.SLIM)
    batches = [vocoder_batch(pcfg, seed=s, b=4) for s in (61, 62)]
    got = groups[2].run(DP.tp_gan_steps, pcfg, batches, 9, 2)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = DP.tp_gan_steps(pcfg, batches, 9, 2)
    finally:
        torch.set_num_threads(threads)
    for r in got:
        assert r['metrics'] == ref['metrics']
        for name, v in ref['params'].items():
            np.testing.assert_array_equal(r['params'][name], v, err_msg=name)


# ---------------------------------------------------------------------------
# (f) the CLI and its checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def npy_corpus(tmp_path_factory):
    return write_npy_corpus(tmp_path_factory.mktemp('npy_corpus'))


@pytest.mark.parametrize('ranks', [2, 4])
def test_rank_0_alone_writes_under_tensor_parallelism(groups, tmp_path, ranks):
    """k=2 on 2 ranks, or 2 x 2 on 4: world rank 0 alone writes both
    trainers' checkpoints (the acoustic one with whole leaves), while the
    other rank of its model group and the other data shard wait; every
    rank restores into its sharded state its slices of the leaves and of
    their moments, and the ranks' whole parameters after a step from it
    are equal."""
    jcfg, pcfg = acoustic_cfg_pair(batch_size=4)
    out = groups[ranks].run(DP.checkpoint_round, pcfg, acoustic_tree(jcfg),
                            _global_acoustic_batch(jcfg), str(tmp_path), 2)
    assert out[0]['writes'] == ['ckpt_00000008', 'g_00000005', 'do_00000005']
    assert all(o['writes'] == [] for o in out[1:])
    for o in out:
        assert o['step'] == 8 and o['restored_equal'] and o['moments_held']
        assert o['gan_step'] == 5 and o['epoch'] == 1
    for o in out[1:]:
        for name, v in out[0]['params'].items():
            np.testing.assert_array_equal(o['params'][name], v, err_msg=name)
    whole = {n: tuple(p.shape) for n, p in Tacotron(pcfg).named_parameters()}
    ck = torch.load(tmp_path / 'ckpt_00000008', map_location='cpu')
    assert {n: tuple(v.shape) for n, v in ck['params'].items()} == whole


def test_cli_checkpoints_resume_both_ways(groups, npy_corpus, tmp_path, monkeypatch):
    """Two ranks with ``--model_parallel 2`` train 2 steps and write a
    gathered ``ckpt_`` (whole leaves and moments, the one-process format);
    one process resumes it to step 4; the two ranks resume that to step 6."""
    cfg = small_cfg(PortConfig, batch_size=4, frame_bucket=40)
    conf = cfg.save(str(tmp_path / 'cfg'))
    run = tmp_path / 'run'
    argv = ['--data_dir', npy_corpus, '--log_path', str(run), '--config', conf,
            '--device', 'cpu', '--log_interval', '1', '--checkpoint_interval', '2',
            '--summary_interval', '100']
    tp = ['--num_devices', '2', '--model_parallel', '2']
    g = groups[2]
    monkeypatch.setitem(sys.modules, 'tensorboard', None)   # see DP.cli
    g.run(DP.cli, 'train.train_acoustic', argv + tp + ['--max_steps', '2'], False)
    whole = {n: tuple(p.shape) for n, p in Tacotron(cfg).named_parameters()}
    ck = torch.load(run / 'ckpt_00000002', map_location='cpu')
    assert {n: tuple(v.shape) for n, v in ck['params'].items()} == whole
    moments = [v['exp_avg'].shape for v in ck['opt_state']['state'].values()]
    assert sorted(map(tuple, moments)) == sorted(whole.values())
    ta.main(argv + ['--max_steps', '4'])
    g.run(DP.cli, 'train.train_acoustic', argv + tp + ['--max_steps', '6'], False)
    log = (run / 'train.log').read_text()
    assert 'tensor parallel over 2 processes per shard' in log
    assert 'resumed from step 2' in log and 'resumed from step 4' in log
    assert 'training complete at step 6' in log
    assert torch.load(run / 'ckpt_00000006', map_location='cpu')['step'] == 6
