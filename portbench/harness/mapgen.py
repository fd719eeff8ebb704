"""The general generator of mapping traffic: batches of SDF samples around a
box-shaped site, keyframe poses, and the decoder's initial weights, all drawn
on the device from the run's seed.

The site's surfaces are the floor and the four side faces of the
configuration's bound, each moved inwards by ``trunc_dist``.  A mix file
gives the shares of uniform and near-surface points, the validity and
free-space rates and the number of batches; a configuration gives the bound,
the truncation distance and the pose count.  The same seed gives the same
tensors: every draw comes from one generator, in a fixed order.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch


def generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def random_rotations(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """n rotations uniform over SO(3), from normalised Gaussian quaternions."""
    q = torch.randn((n, 4), generator=gen, device=device, dtype=torch.float64)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    R = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return R.reshape(n, 3, 3).to(torch.float32)


def decoder_weights(dims: Sequence[int], gen: torch.Generator, device) -> List[Tuple]:
    """((W (in, out), b (out,)), ...) uniform in +-1/sqrt(in), as a freshly
    built linear layer draws them."""
    layers = []
    for fin, fout in zip(dims[:-1], dims[1:]):
        lim = 1.0 / math.sqrt(fin)
        flat = torch.rand((fin * fout + fout,), generator=gen, device=device) * 2.0 - 1.0
        flat = flat * lim
        layers.append((flat[:fin * fout].reshape(fin, fout).contiguous(),
                       flat[fin * fout:].contiguous()))
    return layers


def faces(bound: torch.Tensor, inset: float):
    """(axis, coordinate, inward sign) of the floor and the four side faces."""
    lo, hi = bound[:, 0] + inset, bound[:, 1] - inset
    return [(2, lo[2], 1.0), (0, lo[0], 1.0), (0, hi[0], -1.0),
            (1, lo[1], 1.0), (1, hi[1], -1.0)], lo, hi


def signed_distance(x: torch.Tensor, bound: torch.Tensor, inset: float) -> torch.Tensor:
    """Signed distance to the nearest face: positive inside the open box."""
    fs, _, _ = faces(bound, inset)
    d = torch.stack([(x[:, a] - c) * s for a, c, s in fs], dim=-1)
    return d.min(dim=-1).values


def _surface_points(n, bound, inset, trunc, gen, device):
    """n points within trunc of a face, the face chosen by its area."""
    fs, lo, hi = faces(bound, inset)
    ext = hi - lo
    area = torch.stack([ext[1] * ext[0] if a == 2 else ext[2] * ext[1 - a] for a, _, _ in fs])
    which = torch.multinomial(area / area.sum(), n, replacement=True, generator=gen)
    x = lo + torch.rand((n, 3), generator=gen, device=device) * ext
    off = (torch.rand((n,), generator=gen, device=device) * 2.0 - 1.0) * trunc
    for k, (a, c, s) in enumerate(fs):
        sel = which == k
        x[sel, a] = c + s * off[sel]
    return x


def mapping_batches(mix: Dict, bound: torch.Tensor, trunc: float, num_poses: int,
                    R: torch.Tensor, t: torch.Tensor, gen: torch.Generator,
                    device) -> List[Dict[str, torch.Tensor]]:
    """``mix["batches"]`` batches of ``mix["points_per_step"]`` rows: world
    points (``uniform`` of every ``uniform + surface`` uniform in the bound,
    the rest near a face), their truncated signed distance, validity and
    free-space marks drawn at ``valid_p`` and ``free_p``, and frame ids
    uniform over the poses; the points are handed over in their frame."""
    n = int(mix["points_per_step"])
    n_surf = n * int(mix["surface"]) // (int(mix["uniform"]) + int(mix["surface"]))
    lo, hi = bound[:, 0], bound[:, 1]
    out = []
    for _ in range(int(mix["batches"])):
        x = torch.cat([lo + torch.rand((n - n_surf, 3), generator=gen, device=device) * (hi - lo),
                       _surface_points(n_surf, bound, trunc, trunc, gen, device)])
        x = x[torch.randperm(n, generator=gen, device=device)]
        sdf = signed_distance(x, bound, trunc).clamp(-trunc, trunc)
        ids = torch.randint(0, num_poses, (n,), generator=gen, device=device)
        coords = ((x - t[ids])[:, None, :] * R[ids].transpose(1, 2)).sum(-1)
        marks = torch.rand((n, 2), generator=gen, device=device)
        out.append({
            "coords_frame": coords.contiguous(),
            "sample_frame_ids": ids.to(torch.int32),
            "weights": torch.ones((n, 1), device=device),
            "sdf": sdf[:, None].contiguous(),
            "sdf_valid": (marks[:, :1] < float(mix["valid_p"])).float(),
            "sdf_signs": (marks[:, 1:] < float(mix["free_p"])).float(),
        })
    return out


def mapping_inputs(mix: Dict, bound_list, trunc: float, num_poses: int,
                   decoder_dims: Sequence[int], seed: int, device):
    """Everything a mapping run starts from, in draw order: the decoder, the
    poses (R (K, 3, 3), t (K, 3) uniform in the bound), then the batches."""
    gen = generator(seed, device)
    bound = torch.tensor(bound_list, dtype=torch.float32, device=device)
    decoder = decoder_weights(decoder_dims, gen, device)
    R = random_rotations(num_poses, gen, device)
    lo, hi = bound[:, 0], bound[:, 1]
    t = lo + torch.rand((num_poses, 3), generator=gen, device=device) * (hi - lo)
    batches = mapping_batches(mix, bound, trunc, num_poses, R, t, gen, device)
    return dict(bound=bound, decoder=decoder, R=R, t=t, batches=batches)
