"""Evaluation and trajectory analysis.

- :func:`eval_zero_start` scores a policy on full zero-start episodes run
  in lockstep (:func:`zero_start_returns`): a loop over frames with a
  device-resident alive mask and return accumulator.  Each frame samples
  the policy from the observation and advances the env through
  ``ops.env_rollout.rollout_actions`` with T=1, so on the card every env
  step is one launch of the CUDA rollout kernel.  Given an env shard, each
  rank of a process group plays its share of the episodes through
  ``ops.sharded_rollout.sharded_rollout_actions``.
- :func:`eval_sim` records one episode frame by frame through the same
  kernel (N=1, one launch per frame) as an :class:`EvalSimResult`, whose
  counterfactual sweep (:meth:`EvalSimResult.hypothetical_delta_speeds`)
  is one batched ``phys.apply`` over every (angle, frame) pair on the
  device.
- :func:`draw_inputs` overlays the pressed keys on a video frame,
  :func:`parse_demo` reads a .dem file (``utils/demfile.py``), and
  :func:`plot_all_checkpoints` is the CLI that draws the wish-angle plot of
  each checkpoint of a training run.

The scoring and eval_sim loops are each a frame function on static buffers
with two drivers (``utils/cuda_graph.py``): on a card the frame is captured
once as a CUDA graph and replayed once per frame, as the JAX package
compiles its scans once; on the CPU, and as the yardstick on a card
(``driver="eager"``), it is called once per frame.

matplotlib is imported only inside the functions that draw, so the module
imports without it.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
from pathlib import Path

import numpy as np
import torch

from . import phys
from .env import core as env_core
from .env.config import Config, Key
from .models.policy import Policy, action_dist
from .ops.env_rollout import rollout_actions
from .ops.sharded_rollout import sharded_rollout_actions
from .parallel import distributed
from .parallel.mesh import shard_env_axis
from .utils.cuda_graph import FrameLoop, LoopCache, resolve_driver

__all__ = ("EvalSimResult", "eval_sim", "eval_zero_start",
           "zero_start_returns", "resolve_device", "parse_demo",
           "draw_inputs", "plot_all_checkpoints")

_PLAYER_FIELDS = tuple(f.name for f in dataclasses.fields(phys.PlayerState))


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a card
    rather than falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return device


def _full_float32_products():
    """Float32 matrix products in full float32 on the card (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _episode_steps(cfg: Config) -> int:
    """Frames that cover a whole episode from its full time limit."""
    return int(np.ceil(cfg.time_limit / cfg.time_delta)) + 2


def parse_demo(fname):
    """Read a .dem file -> (times, origins, yaws, finish_time), tracking the
    view entity (``utils/demfile.py``)."""
    from .utils import demfile

    return demfile.parse_demo(fname)


@dataclasses.dataclass
class EvalSimResult:
    """A recorded episode plus derived analytics.

    Per-frame arrays are numpy with leading axis T; ``player_state`` holds
    the *pre-step* state of each frame.  ``device`` is where
    :meth:`hypothetical_delta_speeds` runs: the device the episode ran on
    (``dataclasses.replace(result, device="cpu")`` sweeps on the CPU).
    """

    time_delta: float
    player_state: phys.PlayerState  # of (T,) numpy arrays
    action: np.ndarray     # (T, num_keys [+1]) raw action vector
    obs: np.ndarray        # (T, 6)
    reward: np.ndarray     # (T,)
    yaw: np.ndarray        # (T,) decoded view yaw (degrees)
    smove: np.ndarray      # (T,)
    fmove: np.ndarray      # (T,)
    jump: np.ndarray       # (T,) bool
    device: str = "cuda"

    @property
    def move_angle(self):
        return 180.0 * np.arctan2(np.asarray(self.player_state.vel_y),
                                  np.asarray(self.player_state.vel_x)) / np.pi

    @property
    def wish_angle(self):
        return self.yaw - 180.0 * np.arctan2(self.smove, self.fmove) / np.pi

    @property
    def speed(self):
        return np.hypot(np.asarray(self.player_state.vel_x),
                        np.asarray(self.player_state.vel_y))

    def hypothetical_delta_speeds(self, fmove=800.0, time_delta=0.014):
        """Counterfactual sweep: speed gain at each frame for each of 360
        candidate wish angles (relative to the move angle).  Shape (360, T),
        numpy.

        One ``phys.apply`` over all 360 x T (angle, frame) states, on the
        result's ``device``, in the dtype of the recorded velocities.  Defaults (fmove=800, dt=0.014) are the original
        analysis's hardcoded values.
        """
        device = resolve_device(self.device)
        on_device = lambda x: torch.tensor(np.asarray(x), device=device)
        move_angle = on_device(self.move_angle)
        dtype = move_angle.dtype
        angles = torch.arange(-180.0, 180.0, dtype=dtype, device=device)
        shape = (angles.shape[0], move_angle.shape[0])
        state = phys.PlayerState(**{
            f: on_device(getattr(self.player_state, f)).expand(shape)
            for f in _PLAYER_FIELDS})
        zeros = torch.zeros(shape, dtype=dtype, device=device)
        inputs = phys.Inputs(
            yaw=move_angle + angles[:, None], pitch=zeros, roll=zeros,
            fmove=torch.full(shape, fmove, dtype=dtype, device=device),
            smove=zeros, button2=on_device(self.jump).expand(shape),
            time_delta=torch.full(shape, time_delta, dtype=dtype,
                                  device=device))
        with torch.inference_mode():
            before = torch.hypot(state.vel_x, state.vel_y)
            nxt = phys.apply(inputs, state)
            delta = torch.hypot(nxt.vel_x, nxt.vel_y) - before
        return delta.cpu().numpy()

    def wish_angle_yaw_plot(self, figsize=(20, 16), top_fraction=0.05,
                            ax=None):
        """Heat map of near-optimal wish angles per frame with the agent's
        actual wish angle overlaid: is the agent steering its wish
        direction into the band of angles that maximizes speed gain?

        Per frame, angles whose counterfactual speed gain falls in the top
        ``top_fraction`` quantile are highlighted with intensity scaled
        from the quantile threshold up to the frame optimum (frames where
        no angle changes speed stay dark).
        """
        import matplotlib.pyplot as plt

        delta = self.hypothetical_delta_speeds()      # (360, T)
        q = np.quantile(delta, 1.0 - top_fraction, axis=0, keepdims=True)
        top = delta.max(axis=0, keepdims=True)
        band = np.clip((delta - q) / np.maximum(top - q, 1e-9), 0.0, 1.0)
        band = np.where(np.abs(delta) < 1e-3, 0.0, band)

        if ax is None:
            _, ax = plt.subplots(figsize=figsize)
        im = ax.imshow(band, cmap="viridis", aspect="auto",
                       extent=(0, delta.shape[1], 180, -180))
        rel = ((self.wish_angle - self.move_angle + 180) % 360) - 180
        ax.plot(rel, color="#ff00ff", linestyle="--",
                label="agent wish angle")
        ax.set_ylim(180, -180)
        ax.set_ylabel("wish_angle - move_angle")
        ax.set_xlabel("frame")
        ax.figure.colorbar(im, ax=ax, orientation="horizontal")
        return ax


def _policy_from(policy, env_cfg: Config, deterministic: bool, shard=None):
    """Normalize a policy spec (:class:`Policy` | callable) to
    fn(obs, generator) -> (key_actions (K, N) int32, yaw_action (N,))."""
    if not isinstance(policy, Policy):
        return policy

    def fn(obs, generator):
        dist = action_dist(env_cfg, policy.pi(obs.to(torch.float32)))
        return dist.mode() if deterministic else dist.sample(generator, shard)

    return fn


# Captured loops of Policy objects, by (loop, config, mode, device, shape,
# shard, parameter shapes); each holds its own static copy of the policy,
# into which the scored weights are copied before it runs.  The few most
# recent are kept: a run scores one or two shapes, in both modes.
_LOOPS = LoopCache(8)


def _cached_loop(key, policy, make):
    """The loop that ``make(static_policy)`` builds for ``key``, made once
    per key, with ``policy``'s weights copied into its static policy."""

    def build():
        with torch.inference_mode(False):
            static = copy.deepcopy(policy).requires_grad_(False)
        loop = make(static)
        loop.policy = static
        return loop

    key = key + (tuple(p.shape for p in policy.parameters()),)
    loop = _LOOPS.get(key, build)
    with torch.no_grad():
        for mine, theirs in zip(loop.policy.parameters(),
                                policy.parameters()):
            mine.copy_(theirs)
    return loop


def _loop_for(name, policy, cfg, deterministic, device, driver, size,
              shard, make):
    """The loop ``make(policy_fn)`` that runs ``policy`` on ``size``
    envs (or steps): on the graph driver a Policy's cached loop
    (:func:`_cached_loop`), else a new loop around ``policy`` itself."""
    if driver == "graph" and isinstance(policy, Policy):
        return _cached_loop(
            (name, cfg, deterministic, device, size, shard), policy,
            lambda static: make(_policy_from(static, cfg, deterministic,
                                             shard)))
    return make(_policy_from(policy, cfg, deterministic, shard))


class _SimLoop(FrameLoop):
    """eval_sim's frames at N=1: the env state, the alive flag, and a
    (T, ...) record of each frame written at the device-side index
    ``idx``."""

    def __init__(self, policy_fn, cfg: Config, steps: int, device):
        self.generator = torch.Generator(device)
        super().__init__(device, (self.generator,), (rollout_actions,))
        self.policy_fn, self.cfg, self.steps = policy_fn, cfg, steps
        self.state = env_core.reset(cfg, self.generator, 1, device=device)
        self.rewards = torch.empty((1, 1), dtype=torch.float32, device=device)
        self.dones = torch.empty((1, 1), dtype=torch.bool, device=device)
        self.alive = torch.ones(1, dtype=torch.bool, device=device)
        self.idx = torch.zeros(1, dtype=torch.int64, device=device)
        self.rec = {}

    def start(self, seed: int):
        self.generator.manual_seed(seed)
        self.state.copy_(env_core.reset(self.cfg, self.generator, 1,
                                        device=self.device))
        self.alive.fill_(True)
        self.idx.zero_()

    def _record(self, values: dict):
        for k, v in values.items():
            if k not in self.rec:  # the first frame, never under capture
                self.rec[k] = torch.empty((self.steps,) + tuple(v.shape),
                                          dtype=v.dtype, device=self.device)
            self.rec[k].index_copy_(0, self.idx, v.unsqueeze(0))

    def frame(self):
        cfg, state = self.cfg, self.state
        obs = env_core.compute_obs(cfg, state.player, state.yaw,
                                   state.time_remaining)
        ka, ya = self.policy_fn(obs, self.generator)
        yaw, smove, fmove, jump = env_core.decode_actions(cfg, state, ka, ya)
        self._record({**{f: getattr(state.player, f)
                         for f in _PLAYER_FIELDS},
                      "obs": obs[0], "ka": ka[:, 0], "ya": ya})
        rollout_actions(cfg, state, ka.unsqueeze(0), ya.unsqueeze(0),
                        out=(state, self.rewards, self.dones))
        self._record({"reward": self.rewards[0] * self.alive, "yaw": yaw,
                      "smove": smove, "fmove": fmove, "jump": jump,
                      "alive": self.alive})
        self.alive &= ~self.dones[0]
        self.idx += 1


def eval_sim(policy, env_config: Config, *, seed: int = 0,
             deterministic: bool = False, zero_start: bool = True,
             max_steps: int | None = None, device="cuda",
             driver=None) -> EvalSimResult:
    """Roll out one episode and record its trajectory.

    ``policy`` is a :class:`Policy` on ``device`` or a callable
    ``fn(obs, generator) -> (key_actions, yaw_action)``.  A loop over
    ``max_steps`` frames (default: a whole episode) at N=1: each frame
    builds the observation, runs the policy, decodes the actions (for the
    recorded yaw, smove, fmove and jump), advances the env by one call of
    ``ops.env_rollout.rollout_actions`` with T=1, which on the card is one
    launch of the CUDA kernel, and writes its record into (T, ...) buffers
    at a device-side index.  The record is cut after the frame that ends
    the episode.

    ``driver``: ``"graph"`` (the default on a card) replays the frame as a
    CUDA graph, captured once per config, steps, mode, device and layer
    widths (``utils/cuda_graph.py``); ``"eager"`` (the CPU's) calls it
    once per frame.
    """
    device = resolve_device(device)
    driver = resolve_driver(driver, device)
    _full_float32_products()
    cfg = dataclasses.replace(env_config, num_envs=None)
    if zero_start:
        cfg = dataclasses.replace(cfg, zero_start_prob=1.0)
    if max_steps is None:
        max_steps = _episode_steps(cfg)

    with torch.inference_mode():
        loop = _loop_for("sim", policy, cfg, deterministic, device, driver,
                         max_steps, None,
                         lambda fn: _SimLoop(fn, cfg, max_steps, device))
        loop.start(seed)
        loop.run(max_steps, driver)
        # One copy to the host at the end: (T, ...) numpy per field, apart
        # from the loop's buffers, which its next run overwrites.
        rec = {k: v.to("cpu", copy=True).numpy()
               for k, v in loop.rec.items()}

    t_len = int(rec["alive"][:, 0].sum())
    cut = lambda k: rec[k][:t_len, 0]
    return EvalSimResult(
        time_delta=cfg.time_delta,
        player_state=phys.PlayerState(**{f: cut(f) for f in _PLAYER_FIELDS}),
        action=np.concatenate([rec["ka"][:t_len], rec["ya"][:t_len]],
                              axis=1),
        obs=rec["obs"][:t_len],
        reward=cut("reward"), yaw=cut("yaw"), smove=cut("smove"),
        fmove=cut("fmove"), jump=cut("jump"), device=str(device))


class _ZeroStartLoop(FrameLoop):
    """eval_zero_start's frames: the env state of this rank's episodes,
    their returns and alive flags."""

    def __init__(self, policy_fn, cfg: Config, n: int, device, shard=None):
        self.generator = torch.Generator(device)
        self.step = (rollout_actions if shard is None
                     else sharded_rollout_actions)
        super().__init__(device, (self.generator,),
                         (rollout_actions, sharded_rollout_actions))
        self.policy_fn, self.cfg, self.n, self.shard = policy_fn, cfg, n, shard
        self.state = self._reset()
        local = self.state.num_envs
        self.rewards = torch.empty((1, local), dtype=torch.float32,
                                   device=device)
        self.dones = torch.empty((1, local), dtype=torch.bool, device=device)
        self.ret = torch.zeros(local, dtype=torch.float32, device=device)
        self.alive = torch.ones(local, dtype=torch.bool, device=device)

    def _reset(self):
        state = env_core.reset(self.cfg, self.generator, self.n,
                               device=self.device)
        return state if self.shard is None else shard_env_axis(state,
                                                               self.shard)

    def start(self, seed: int):
        self.generator.manual_seed(seed)
        self.state.copy_(self._reset())
        self.ret.zero_()
        self.alive.fill_(True)

    def frame(self):
        cfg, state = self.cfg, self.state
        obs = env_core.compute_obs(cfg, state.player, state.yaw,
                                   state.time_remaining)
        ka, ya = self.policy_fn(obs, self.generator)
        self.step(cfg, state, ka.unsqueeze(0), ya.unsqueeze(0),
                  out=(state, self.rewards, self.dones))
        self.ret += self.rewards[0] * self.alive
        self.alive &= ~self.dones[0]


def zero_start_returns(policy, env_config: Config, *,
                       num_episodes: int = 512, deterministic: bool = False,
                       seed: int = 0, device="cuda", shard=None,
                       driver=None) -> np.ndarray:
    """The returns of ``num_episodes`` full zero-start episodes run in
    lockstep, as a (num_episodes,) float32 numpy array: what
    :func:`eval_zero_start` summarizes.

    Each frame samples the policy from the observation (or takes its mode
    with ``deterministic``) and advances the envs by one call of
    ``rollout_actions`` with T=1, one launch of the CUDA kernel on the
    card.  ``shard``: as in :func:`eval_zero_start`.  ``driver``:
    ``"graph"`` (the default on a card) replays the frame as a CUDA graph,
    captured once per config, episodes, mode, device, shard and layer
    widths; the JAX package likewise compiles its scan once per config, N,
    steps and mode.  ``"eager"`` (the CPU's) calls the frame once per
    frame.
    """
    device = resolve_device(device)
    driver = resolve_driver(driver, device)
    _full_float32_products()
    cfg = dataclasses.replace(env_config, num_envs=None, zero_start_prob=1.0)
    with torch.inference_mode():
        loop = _loop_for("zero_start", policy, cfg, deterministic, device,
                         driver, num_episodes, shard,
                         lambda fn: _ZeroStartLoop(fn, cfg, num_episodes,
                                                   device, shard))
        loop.start(seed)
        loop.run(_episode_steps(cfg), driver)
        ret = loop.ret
        if shard is not None:
            ret = distributed.gather_env_axis(ret, shard)
        return ret.to("cpu", copy=True).numpy()


def eval_zero_start(policy, env_config: Config, *, num_episodes: int = 512,
                    deterministic: bool = False, seed: int = 0,
                    device="cuda", shard=None) -> dict:
    """Batch-evaluate zero-start performance: the low-variance measurement
    of the training north-star.

    ``policy`` is a :class:`Policy` on ``device`` or a callable
    ``fn(obs, generator) -> (key_actions, yaw_action)``.  Runs
    ``num_episodes`` full zero-start episodes in lockstep
    (:func:`zero_start_returns`, graphed on a card) and returns summary
    stats.  Float32 matrix products run in full float32 (TF32 off).

    ``shard``: a ``parallel.mesh.EnvShard`` of the ``num_episodes``
    episodes; this rank plays its share, drawing what one process would
    for those episodes from the generator every rank seeds alike, and the
    returns are gathered, so every rank returns the same summary.
    """
    ret = zero_start_returns(policy, env_config, num_episodes=num_episodes,
                             deterministic=deterministic, seed=seed,
                             device=device, shard=shard)
    return {
        "mean": float(ret.mean()), "median": float(np.median(ret)),
        "std": float(ret.std()), "min": float(ret.min()),
        "max": float(ret.max()), "num_episodes": num_episodes,
    }


def _arrow_polygon(length, width, head_frac):
    """Arrow outline pointing +y from the origin: a shaft rectangle topped
    by a triangular head, counter-clockwise (the visual contract — filled
    directional arrows — is the original key overlay's)."""
    body = length * (1.0 - head_frac)
    half = 0.5 * width
    barb = length * head_frac
    return np.array([
        (half, 0.0), (half, body), (barb, body), (0.0, length),
        (-barb, body), (-half, body), (-half, 0.0)])


def _rasterize_polygon(im, pts, color, supersample=2):
    """Alpha-composite a filled polygon onto an RGBA uint8 image.

    Coverage is computed by point-in-polygon tests on a ``supersample``x
    subpixel grid over the polygon's bounding box (numpy + matplotlib.path
    — no OpenCV dependency)."""
    from matplotlib.path import Path as MplPath

    h, w = im.shape[:2]
    x0 = max(int(np.floor(pts[:, 0].min())), 0)
    x1 = min(int(np.ceil(pts[:, 0].max())) + 1, w)
    y0 = max(int(np.floor(pts[:, 1].min())), 0)
    y1 = min(int(np.ceil(pts[:, 1].max())) + 1, h)
    if x0 >= x1 or y0 >= y1:
        return

    s = supersample
    xs = x0 + (np.arange((x1 - x0) * s) + 0.5) / s
    ys = y0 + (np.arange((y1 - y0) * s) + 0.5) / s
    gx, gy = np.meshgrid(xs, ys)
    inside = MplPath(pts).contains_points(
        np.column_stack([gx.ravel(), gy.ravel()]))
    cov = (inside.reshape(y1 - y0, s, x1 - x0, s)
           .astype(np.float32).mean(axis=(1, 3)))

    region = im[y0:y1, x0:x1].astype(np.float32)
    color = np.asarray(color, np.float32)
    a = cov[..., None]
    region[..., :3] = region[..., :3] * (1 - a) + color[:3] * a
    region[..., 3] = np.maximum(region[..., 3], color[3] * cov)
    im[y0:y1, x0:x1] = region.astype(np.uint8)


def _draw_arrow(im, pos, vec, width, head_size, color, xform):
    """Render a filled arrow onto an RGBA image at ``pos`` pointing along
    ``vec`` (length = |vec|), under the affine ``xform``."""
    length = float(np.linalg.norm(vec))
    if length < 1e-5:
        return
    d = np.asarray(vec, float) / length
    # Rotate the +y-pointing template onto d, translate to pos, then apply
    # the caller's placement transform.
    local = np.array([[d[1], d[0], pos[0]],
                      [-d[0], d[1], pos[1]],
                      [0.0, 0.0, 1.0]])
    poly = _arrow_polygon(length, width, head_size)
    pts_h = np.column_stack([poly, np.ones(len(poly))]) @ (xform @ local).T
    _rasterize_polygon(im, pts_h[:, :2], color)


def _draw_arrow_key(im, pos, vec, pressed, xform):
    color = [0, 255, 255, 255] if pressed else [200, 200, 200, 255]
    _draw_arrow(im, np.asarray(pos, float), np.asarray(vec, float),
                8.0, 0.4, color, xform)


def draw_inputs(im, keys, yaw, xform):
    """Overlay pressed-key arrows (WASD layout) onto a video frame: forward
    up, strafes sideways, an always-unpressed back arrow for symmetry."""
    _draw_arrow_key(im, [40, 20], [0, -20], keys[Key.FORWARD], xform)
    _draw_arrow_key(im, [20, 40], [-20, 0], keys[Key.STRAFE_LEFT], xform)
    _draw_arrow_key(im, [40, 30], [0, 20], False, xform)
    _draw_arrow_key(im, [60, 40], [20, 0], keys[Key.STRAFE_RIGHT], xform)


def plot_all_checkpoints(argv=None):
    """CLI: render a wish-angle plot per checkpoint of a training run.

    usage: q1physrl-torch-plot-checkpoints <run.yml> <checkpoint_dir>
               <output_dir> [--device cuda|cpu]

    Reads the RLLib policy pickle of each ``iter_*`` directory that the
    port's trainer wrote, records one stochastic zero-start episode with
    :func:`eval_sim` on the device, and writes ``output_dir/NNNN.png``.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from .algo.checkpoint import POLICY_FILE
    from .algo.config import load_run_config
    from .models.import_rllib import import_policy_params

    parser = argparse.ArgumentParser(
        prog="q1physrl-torch-plot-checkpoints",
        description="Draw the wish-angle plot of every checkpoint of a "
                    "training run.")
    parser.add_argument("run_yaml")
    parser.add_argument("checkpoint_dir")
    parser.add_argument("output_dir")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    run = load_run_config(args.run_yaml)
    device = resolve_device(args.device)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    policy = Policy(run.env, device=device)
    paths = sorted(Path(args.checkpoint_dir).glob("iter_*"))
    for i, path in enumerate(paths):
        policy.load_state_dict(import_policy_params(str(path / POLICY_FILE)))
        eval_sim(policy, run.env, device=device).wish_angle_yaw_plot()
        output_path = out / f"{i:04d}.png"
        plt.savefig(output_path)
        plt.close()
        print(f"Wrote {output_path}")
