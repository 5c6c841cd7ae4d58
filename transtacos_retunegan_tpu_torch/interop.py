"""Reference RetuneGAN checkpoints -> flax-layout parameter trees, ported
from ``transtacos_retunegan_tpu/interop.py`` (the same maps and numpy
arithmetic, so the trees are equal to the JAX package's bit for bit).

Converts the weight-normalized torch conv layers of the reference
RetuneGAN (``retunegan/models/generator.py``,
``retunegan/models/discrminator.py``) into the flax layout that
``weights.from_flax`` loads into the port's modules.  ``import_g_checkpoint``
and ``import_do_checkpoint`` read a trained reference ``g_<step>`` /
``do_<step>`` (``retunegan/train.py:63-88`` load semantics);
``tools/import_reference_ckpt.py`` writes them as the port's own
checkpoints.  ``seeded_state_dict`` makes a seeded state dict in the
reference's layout from a map, for tests of the import path.

Mapping strategy: the *effective* conv weight ``w = g * v / ||v||`` is
transplanted, and the (v, g) split is re-derived per OUTPUT channel
(``v = w``, ``g = sqrt(||w||^2 + 1e-12)`` so ``g * v / sqrt(||v||^2 + eps)
== w`` exactly).  For Conv1d/Conv2d this matches torch's dim=0 weight-norm
grouping; for ConvTranspose1d torch groups per INPUT channel
(``weight_g: [in, 1, 1]``), so the (v, g) split differs while the effective
weight -- and therefore the function computed -- is preserved.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# layer kinds: torch conv weight layout -> flax [spatial..., cin, cout]
C1 = 'conv1d'         # torch [out, in/g, k]   -> flax [k, in/g, out]
CT1 = 'convtr1d'      # torch [in, out, k]     -> flax [k, in, out]
C2 = 'conv2d'         # torch [out, in, kh, kw]-> flax [kh, kw, in, out]
RAW = 'raw'           # direct tensor copy (alpha, noise.w)

_PERMS = {C1: (2, 1, 0), CT1: (2, 0, 1), C2: (2, 3, 1, 0)}

MapEntry = Tuple[str, str, str]   # (flax_path 'a/b/c', torch_prefix, kind)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, 'detach') else np.asarray(t)


def _effective_weight(sd: Dict, prefix: str) -> np.ndarray:
    """Effective conv weight from a (possibly weight-normed) torch layer.

    torch ``nn.utils.weight_norm`` (dim=0) stores ``weight_g`` / ``weight_v``
    with ``w = g * v / ||v||`` where the norm runs over all dims except 0.
    """
    if f'{prefix}.weight_v' in sd:
        v = _np(sd[f'{prefix}.weight_v']).astype(np.float64)
        g = _np(sd[f'{prefix}.weight_g']).astype(np.float64)
        axes = tuple(range(1, v.ndim))
        n = np.sqrt(np.sum(v * v, axis=axes, keepdims=True))
        return (v * (g / n)).astype(np.float32)
    return _np(sd[f'{prefix}.weight']).astype(np.float32)


def _conv_entry(sd: Dict, prefix: str, kind: str) -> Dict[str, np.ndarray]:
    """flax {v, g, b} for one WNConv/WNConvTranspose/WNConv2d layer."""
    w = _effective_weight(sd, prefix).transpose(_PERMS[kind])
    axes = tuple(range(w.ndim - 1))
    # g = sqrt(sum(v^2) + eps) makes the flax effective weight equal w exactly
    # (vocoder_layers.py adds 1e-12 inside the sqrt)
    g = np.sqrt(np.sum(w.astype(np.float64) ** 2, axis=axes) + 1e-12)
    out = {'v': w, 'g': g.astype(np.float32)}
    if f'{prefix}.bias' in sd:
        out['b'] = _np(sd[f'{prefix}.bias']).astype(np.float32)
    else:
        out['b'] = np.zeros(w.shape[-1], np.float32)
    return out


def _insert(tree: Dict, path: str, leaf) -> None:
    keys = path.split('/')
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = leaf


def transplant(sd: Dict, mapping: Sequence[MapEntry]) -> Dict:
    """Build a flax param tree from a torch state_dict using a layer map."""
    tree: Dict = {}
    for flax_path, torch_prefix, kind in mapping:
        if kind == RAW:
            _insert(tree, flax_path, _np(sd[torch_prefix]).astype(np.float32))
        else:
            entry = _conv_entry(sd, torch_prefix, kind)
            for name, arr in entry.items():
                _insert(tree, f'{flax_path}/{name}', arr)
    return tree


# --------------------------------------------------------------------------
# generator maps (flax module call order vs torch __init__ names)

def _residual_stack_map(flax_prefix: str, torch_prefix: str) -> List[MapEntry]:
    """MelGAN ResidualStack: res_{1,2,3} Sequentials, convs at indices 1/3
    (reference ``generator.py:33-77``); flax WNConv_0..5 in the same order."""
    m: List[MapEntry] = []
    for unit, (seq, idx) in enumerate(
            [('res_1', 1), ('res_1', 3), ('res_2', 1), ('res_2', 3),
             ('res_3', 1), ('res_3', 3)]):
        m.append((f'{flax_prefix}/WNConv_{unit}',
                  f'{torch_prefix}.{seq}.{idx}', C1))
    return m


def _resblock_map(flax_prefix: str, torch_prefix: str, n_convs: int
                  ) -> List[MapEntry]:
    """HiFiGAN ResBlock/ResBlock3: convs.0..n-1 -> WNConv_0..n-1."""
    return [(f'{flax_prefix}/WNConv_{c}', f'{torch_prefix}.convs.{c}', C1)
            for c in range(n_convs)]


def _resblock_full_map(flax_prefix: str, torch_prefix: str) -> List[MapEntry]:
    """ResBlock_full: convs1/convs2 interleaved per dilation
    (reference ``generator.py:157-187``); flax calls them alternately."""
    m: List[MapEntry] = []
    for d in range(3):
        m.append((f'{flax_prefix}/WNConv_{2 * d}', f'{torch_prefix}.convs1.{d}', C1))
        m.append((f'{flax_prefix}/WNConv_{2 * d + 1}', f'{torch_prefix}.convs2.{d}', C1))
    return m


def map_refinegan_small() -> List[MapEntry]:
    """Generator_RefineGAN_small (reference ``generator.py:670-796``) ->
    ``GeneratorRefineGANSmall``."""
    m: List[MapEntry] = [('WNConv_0', 'conv_pre', C1)]
    for i in range(3):
        m.append((f'WNConv_{i + 1}', f'downs.{i}', C1))
        m += _residual_stack_map(f'enc_rs_{i}', f'resblock.{i}')
    m.append(('conv_fuse', 'conv_fuse', C1))
    for i in range(3):
        m.append((f'WNConvTranspose_{i}', f'ups.{i}', CT1))
        m.append((f'merge_{i}', f'merge.{i}', C1))
        for j in range(3):
            m += _resblock_map(f'dec_rb_{i}_{j}', f'resblocks.{i * 3 + j}', 3)
    m.append(('WNConv_4', 'conv_post', C1))
    m.append(('noise/w', 'noise.w', RAW))
    return m


def map_hifigan(n_ups: int = 3, n_kernels: int = 3, use_post: bool = True,
                prefix: str = '') -> List[MapEntry]:
    """Generator_HiFiGAN (reference ``generator.py:389-434``) ->
    ``GeneratorHiFiGAN``.  ResBlock here has 2 convs per dilation pair."""
    p = f'{prefix}/' if prefix else ''
    tp = f'{prefix}.' if prefix else ''
    m: List[MapEntry] = [(f'{p}WNConv_0', f'{tp}conv_pre', C1)]
    for i in range(n_ups):
        m.append((f'{p}WNConvTranspose_{i}', f'{tp}ups.{i}', CT1))
        for j in range(n_kernels):
            m += _resblock_map(f'{p}resblock_{i}_{j}',
                               f'{tp}resblocks.{i * n_kernels + j}', 2)
    if use_post:
        m.append((f'{p}WNConv_1', f'{tp}conv_post', C1))
    return m


def map_hifigan_mini(n_ups: int = 3) -> List[MapEntry]:
    """Generator_HiFiGAN_mini (reference ``generator.py:437-477``)."""
    m: List[MapEntry] = [('WNConv_0', 'conv_pre', C1)]
    for i in range(n_ups):
        m.append((f'WNConvTranspose_{i}', f'ups.{i}', CT1))
        m += _resblock_full_map(f'ResBlockFull_{i}', f'resblocks.{i}')
    m.append(('WNConv_1', 'conv_post', C1))
    return m


def _melgan_block_map(flax_prefix: str, torch_prefix: str,
                      resize: str = 'u') -> List[MapEntry]:
    """MelGAN ResidualBlock (reference ``generator.py:79-107``): ``pre``
    (ConvTranspose1d for 'u', strided Conv1d for 'd') + ``res_stack``."""
    pre_name = 'WNConvTranspose_0' if resize == 'u' else 'WNConv_0'
    m: List[MapEntry] = [(f'{flax_prefix}/{pre_name}', f'{torch_prefix}.pre',
                          CT1 if resize == 'u' else C1)]
    m += _residual_stack_map(f'{flax_prefix}/ResidualStack_0',
                             f'{torch_prefix}.res_stack')
    return m


def map_melgan(use_post: bool = True, prefix: str = '') -> List[MapEntry]:
    """Generator_MelGAN (reference ``generator.py:232-259``): ``pre`` +
    4 ResidualBlocks (``res_blocks.{i}.pre`` + ``.res_stack``) + ``post``."""
    p = f'{prefix}/' if prefix else ''
    tp = f'{prefix}.' if prefix else ''
    m: List[MapEntry] = [(f'{p}WNConv_0', f'{tp}pre', C1)]
    for i in range(4):
        m.append((f'{p}ResidualBlock_{i}/WNConvTranspose_0',
                  f'{tp}res_blocks.{i}.pre', CT1))
        m += _residual_stack_map(f'{p}ResidualBlock_{i}/ResidualStack_0',
                                 f'{tp}res_blocks.{i}.res_stack')
    if use_post:
        m.append((f'{p}WNConv_1', f'{tp}post', C1))
    return m


def map_melgan_retune() -> List[MapEntry]:
    """Generator_MelGANRetune (reference ``generator.py:262-340``): mel
    branch (pre_x + 2 up blocks), template branch (pre_y + 2 down blocks),
    learnable-alpha concat fuse, joint decoder (2 up blocks) + post."""
    m: List[MapEntry] = [('WNConv_0', 'pre_x', C1)]
    for i in range(2):
        m += _melgan_block_map(f'ResidualBlock_{i}', f'ups_x.{i}', 'u')
    m.append(('WNConv_1', 'pre_y', C1))
    for i in range(2):
        m += _melgan_block_map(f'ResidualBlock_{i + 2}', f'downs_y.{i}', 'd')
    m.append(('alpha', 'alpha', RAW))
    for i in range(2):
        m += _melgan_block_map(f'ResidualBlock_{i + 4}', f'ups_z.{i}', 'u')
    m.append(('WNConv_2', 'post', C1))
    return m


def map_melgan_split() -> List[MapEntry]:
    """Generator_MelGANSplit (reference ``generator.py:343-386``): two
    post-less MelGANs (consonant/vowel), u/v masked sum, conjunction-refine
    conv + ResidualStack + post."""
    m = map_melgan(use_post=False, prefix='g_c')
    m += map_melgan(use_post=False, prefix='g_v')
    m.append(('WNConv_0', 'conv', C1))
    m += _residual_stack_map('ResidualStack_0', 'res_stack')
    m.append(('WNConv_1', 'post', C1))
    return m


def map_hifigan_retune() -> List[MapEntry]:
    """Generator_HiFiGANRetune (reference ``generator.py:799-898``): HiFiGAN
    mel branch (2 up stages x 3-kernel MRF), template down branch
    (2 strided convs + ResBlock_full), alpha concat fuse, joint decoder
    (2 up stages x MRF) + post."""
    m: List[MapEntry] = [('WNConv_0', 'pre_x', C1)]
    for i in range(2):
        m.append((f'WNConvTranspose_{i}', f'ups_x.{i}', CT1))
        for j in range(3):
            m += _resblock_map(f'x_rb_{i}_{j}', f'resblocks_x.{i * 3 + j}', 2)
    m.append(('WNConv_1', 'pre_y', C1))
    for i in range(2):
        m.append((f'WNConv_{i + 2}', f'downs_y.{i}', C1))
        m += _resblock_full_map(f'y_rb_{i}', f'resblock_y.{i}')
    m.append(('alpha', 'alpha', RAW))
    for i in range(2):
        m.append((f'WNConvTranspose_{i + 2}', f'ups_z.{i}', CT1))
        for j in range(3):
            m += _resblock_map(f'z_rb_{i}_{j}', f'resblocks_z.{i * 3 + j}', 2)
    m.append(('WNConv_4', 'post', C1))
    return m


def map_hifigan_split() -> List[MapEntry]:
    """Generator_HiFiGANSplit (reference ``generator.py:901-942``): two
    post-less HiFiGANs, u/v masked sum, refine conv + post."""
    m = map_hifigan(use_post=False, prefix='g_c')
    m += map_hifigan(use_post=False, prefix='g_v')
    m.append(('WNConv_0', 'conv', C1))
    m.append(('WNConv_1', 'post', C1))
    return m


def map_retunecnn() -> List[MapEntry]:
    """Generator_RetuneCNN (reference ``generator.py:193-229``): pure
    wave-to-wave conv stack on the template."""
    m: List[MapEntry] = [('WNConv_0', 'conv_pre', C1)]
    for i in range(6):
        m.append((f'WNConv_{i + 1}', f'convs.{i}', C1))
    m.append(('WNConv_7', 'conv_post', C1))
    return m


def map_hifigan_micro(n_ups: int = 3) -> List[MapEntry]:
    """Generator_HiFiGAN_micro (reference ``generator.py:480-520``): one
    plain k41 conv per upsample stage.  The reference leaves the stage convs
    un-weight-normed; ``_conv_entry`` re-derives the flax (v, g) split from
    the effective weight either way, so the function transplants exactly."""
    m: List[MapEntry] = [('WNConv_0', 'conv_pre', C1)]
    for i in range(n_ups):
        m.append((f'WNConvTranspose_{i}', f'ups.{i}', CT1))
        m.append((f'WNConv_{i + 1}', f'resblocks.{i}', C1))
    m.append((f'WNConv_{n_ups + 1}', 'conv_post', C1))
    return m


def map_hifigan_mu(n_ups: int = 3) -> List[MapEntry]:
    """Generator_HiFiGAN_mu (reference ``generator.py:523-557``):
    upsample-only ablation."""
    m: List[MapEntry] = [('WNConv_0', 'conv_pre', C1)]
    for i in range(n_ups):
        m.append((f'WNConvTranspose_{i}', f'ups.{i}', CT1))
    m.append(('WNConv_1', 'conv_post', C1))
    return m


def map_refinegan(n_ups: int = 3) -> List[MapEntry]:
    """Generator_RefineGAN, full-width UNet (reference
    ``generator.py:560-667``): template encoder (conv_pre_y + strided downs
    + single ResBlock per stage), mel prenet concat at the bottleneck,
    transposed-conv decoder with skip-concat merges + 3-kernel MRF and the
    shared learnable-noise injection."""
    m: List[MapEntry] = [('WNConv_0', 'conv_pre_y', C1)]
    for i in range(n_ups):
        m.append((f'WNConv_{i + 1}', f'downs.{i}', C1))
        m += _resblock_map(f'enc_rb_{i}', f'resblock.{i}', 2)
    m.append((f'WNConv_{n_ups + 1}', 'conv_pre', C1))
    for i in range(n_ups):
        m.append((f'WNConvTranspose_{i}', f'ups.{i}', CT1))
        m.append((f'merge_{i}', f'merge.{i}', C1))
        for j in range(3):
            m += _resblock_map(f'dec_rb_{i}_{j}', f'resblocks.{i * 3 + j}', 2)
    m.append((f'WNConv_{n_ups + 2}', 'conv_post', C1))
    m.append(('noise/w', 'noise.w', RAW))
    return m


GENERATOR_MAPS = {
    'RetuneCNN': map_retunecnn,
    'MelGAN': map_melgan,
    'MelGANRetune': map_melgan_retune,
    'MelGANSplit': map_melgan_split,
    'HiFiGAN': map_hifigan,
    'HiFiGAN_mini': map_hifigan_mini,
    'HiFiGAN_micro': map_hifigan_micro,
    'HiFiGAN_mu': map_hifigan_mu,
    'RefineGAN': map_refinegan,
    'RefineGAN_small': map_refinegan_small,
    'HiFiGANRetune': map_hifigan_retune,
    'HiFiGANSplit': map_hifigan_split,
}


# --------------------------------------------------------------------------
# discriminator maps

def map_disc_s(flax_prefix: str = '', torch_prefix: str = '') -> List[MapEntry]:
    """DiscriminatorS, MelGAN_small flavor (reference
    ``discrminator.py:36-45``): convs.0..5 + conv_post."""
    p = f'{flax_prefix}/' if flax_prefix else ''
    tp = f'{torch_prefix}.' if torch_prefix else ''
    m = [(f'{p}conv_{i}', f'{tp}convs.{i}', C1) for i in range(6)]
    m.append((f'{p}conv_post', f'{tp}conv_post', C1))
    return m


def map_disc_p(flax_prefix: str = '', torch_prefix: str = '') -> List[MapEntry]:
    """DiscriminatorP, HiFiGAN_small flavor (reference
    ``discrminator.py:155-163``): convs.0..4 + conv_post, all Conv2d."""
    p = f'{flax_prefix}/' if flax_prefix else ''
    tp = f'{torch_prefix}.' if torch_prefix else ''
    m = [(f'{p}conv_{i}', f'{tp}convs.{i}', C2) for i in range(5)]
    m.append((f'{p}conv_post', f'{tp}conv_post', C2))
    return m


def map_disc_stft(flax_prefix: str = '', torch_prefix: str = '') -> List[MapEntry]:
    """StftDiscriminator (reference ``discrminator.py:255-262``)."""
    p = f'{flax_prefix}/' if flax_prefix else ''
    tp = f'{torch_prefix}.' if torch_prefix else ''
    m = [(f'{p}conv_{i}', f'{tp}convs.{i}', C2) for i in range(5)]
    m.append((f'{p}conv_post', f'{tp}conv_post', C2))
    return m


def map_msd(n_layers: int = 3) -> List[MapEntry]:
    m: List[MapEntry] = []
    for i in range(n_layers):
        m += map_disc_s(f'disc_{i}', f'discriminators.{i}')
    return m


def map_mpd(periods: Sequence[int] = (3, 5, 7, 11)) -> List[MapEntry]:
    m: List[MapEntry] = []
    for i, p in enumerate(periods):
        m += map_disc_p(f'disc_p{p}', f'discriminators.{i}')
    return m


def map_mtd(n_res: int = 3) -> List[MapEntry]:
    m: List[MapEntry] = []
    for i in range(n_res):
        m += map_disc_stft(f'disc_{i}', f'discriminators.{i}')
    return m


# --------------------------------------------------------------------------
# checkpoint-level importers

def import_generator_state_dict(sd: Dict, ver: str) -> Dict:
    """torch generator state_dict -> flax param tree for GENERATORS[ver]."""
    if ver not in GENERATOR_MAPS:
        raise ValueError(
            f'no torch->flax map for generator {ver!r}; mapped: '
            f'{sorted(GENERATOR_MAPS)}')
    return transplant(sd, GENERATOR_MAPS[ver]())


def import_g_checkpoint(path: str, ver: str = 'RefineGAN_small') -> Dict:
    """Load a reference ``g_<step>`` checkpoint (``{'generator': state_dict}``,
    saved at ``retunegan/train.py:214-218``) as a flax param tree."""
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    return import_generator_state_dict(ckpt['generator'], ver)


def import_do_checkpoint(path: str, cfg=None) -> Dict[str, Dict]:
    """Load a reference ``do_<step>`` checkpoint (msd/mpd/mtd + optim states)
    as flax param trees for the three discriminators."""
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    msd_layers = cfg.vocoder.msd_layers if cfg is not None else 3
    periods = cfg.vocoder.mpd_periods if cfg is not None else (3, 5, 7, 11)
    n_res = len(cfg.vocoder.multi_stft_params) if cfg is not None else 3
    return {
        'msd': transplant(ckpt['msd'], map_msd(msd_layers)),
        'mpd': transplant(ckpt['mpd'], map_mpd(periods)),
        'mtd': transplant(ckpt['mtd'], map_mtd(n_res)),
        'steps': int(ckpt.get('steps', 0)),
        'epoch': int(ckpt.get('epoch', -1)),
    }


def seeded_state_dict(module, mapping: Sequence[MapEntry], seed: int) -> Dict:
    """A seeded state dict in the reference RetuneGAN's torch layout for
    ``mapping``, on the shapes of the port's ``module`` (its parameters are
    named after the flax paths and hold the torch conv layouts): each conv
    as ``weight_g``/``weight_v`` under torch's dim-0 weight norm
    (``weight_g`` [dim 0, 1, ...]), every fifth one as a plain ``weight``,
    a bias on all but every seventh, the raw tensors (``alpha``,
    ``noise.w``) as they are; directions scaled by their fan-in."""
    rng = np.random.RandomState(seed)
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    sd = {}
    for i, (flax_path, prefix, kind) in enumerate(mapping):
        key = flax_path.replace('/', '.')
        if kind == RAW:
            sd[prefix] = torch.from_numpy((0.1 * rng.randn(*shapes[key])).astype(np.float32))
            continue
        shape = shapes[f'{key}.v']
        v = rng.randn(*shape).astype(np.float32) / np.sqrt(np.prod(shape[1:]))
        if i % 5 == 4:
            sd[f'{prefix}.weight'] = torch.from_numpy(v)
        else:
            g = 1.0 + 0.5 * rng.rand(shape[0], *[1] * (len(shape) - 1))
            sd[f'{prefix}.weight_v'] = torch.from_numpy(v)
            sd[f'{prefix}.weight_g'] = torch.from_numpy(g.astype(np.float32))
        if i % 7 != 6:
            sd[f'{prefix}.bias'] = torch.from_numpy(
                (0.1 * rng.randn(*shapes[f'{key}.b'])).astype(np.float32))
    return sd
