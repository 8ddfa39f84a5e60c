"""A2C actor-learner step, evaluation and recording (counterpart of
``deeprl_network_tpu/utils/rollout.py``).

    train_step(ts) -> (ts', metrics)

runs T = n_step control steps of B batched env instances (policy forward,
Gumbel-max action sampling, env dynamics with auto-reset, fingerprint
update, episode bookkeeping), computes normalized, spatially discounted
n-step returns from a bootstrap V(s_T), takes the A2C gradient over the
window (truncated BPTT), applies the TF1 RMSProp update to the f32 master
params and, for IA2C_CU, the weight consensus.

Two gradient paths share one rollout step (``_env_policy_step``):

- fused (``fused_grad=True``, the default): the loss is differentiated
  through the rollout itself. What the replay treats as recorded constants
  is detached: obs, rewards, new fingerprints, the bootstrap value; the env
  runs outside autograd. With ``remat`` each step's policy forward runs
  under ``torch.utils.checkpoint`` and is recomputed in the backward pass.
  The Gumbel noise is drawn outside that checkpoint, and the action is
  taken from the forward's logits, so the recompute never samples.
- replay (``fused_grad=False``): a rollout without gradients records the
  window, then ``models/a2c.a2c_loss`` runs the policy again over it from
  the carry the window started with.

``train_step`` is a host wrapper around the update body ``_update``, a
function of tensors only that reads nothing back to the host: the wrapper
computes the entropy coefficient, the kickstart weight and the learning
rate on the host (from ``ts.step`` and the optimizer's count, which stay
host ints that it advances) into a small f32 tensor the body reads. With
``jit=True`` (the default, the JAX package's ``jax.jit(train_step,
donate_argnums=0)``) a CUDA device runs the body as one CUDA graph an
update (``utils/graph.py``): captured at the first call, replayed at every
later one. On the CPU, and with ``jit=False``, the body runs eagerly.

Spans (``utils/spans.py``): the body marks its spans on the card (update,
rollout, sampled steps with their policy, comm and env, returns, backward,
all-reduce, optimizer; the graph adds its own), and ``train_step`` times its
host spans; ``fns.spans.read(n)`` reads the last n updates.

``eval_episode`` and ``record_episode`` run one env instance (B = 1 through
the same batched functions) with f32 params.

Data parallelism (``axis_name``, driven by ``parallel/train.py``): rank r
holds rows ``[r*B, (r+1)*B)`` of a global batch of ``B * n_replicas``
envs. Every rank seeds one generator alike and draws every noise tensor
(initial reset, Gumbel noise, auto-reset) at the GLOBAL batch shape,
keeping its own rows, so the generators stay in lockstep and the global
batch draws exactly what one process draws: an N-rank update equals the
1-rank update on the combined batch up to float reassociation. The
gradients and the device-side metrics are averaged over ranks by one
``all_reduce`` before the optimizer.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import (
    Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union,
)

import torch
from torch.utils.checkpoint import checkpoint

from deeprl_network_tpu_torch.config import ModelConfig, TrainConfig
from deeprl_network_tpu_torch.envs.base import Env
from deeprl_network_tpu_torch.envs.wrappers import AutoResetEnv
from deeprl_network_tpu_torch.models.a2c import (
    Rollout, a2c_loss, a2c_loss_terms, action_stats, normalize_rewards,
    nstep_returns, spatial_mix,
)
from deeprl_network_tpu_torch.models.layers import (
    RMSPropState, TF1RMSProp, global_norm, tf1_rmsprop,
)
from deeprl_network_tpu_torch.models.policies import (
    AGENT_TO_COMM, Carry, PolicyParams, PolicySpec, consensus_tables,
    consensus_update, embed_marks, init_carry, init_fingerprint,
    init_policy_params, mask_comm_params, policy_consts, policy_step_batched,
    tree_leaves, tree_map, tree_unflatten,
)
from deeprl_network_tpu_torch.parallel import distributed
from deeprl_network_tpu_torch.utils.device import resolve_device
from deeprl_network_tpu_torch.utils.graph import GraphedStep, HostScalars
from deeprl_network_tpu_torch.utils.scheduler import make_schedule
from deeprl_network_tpu_torch.utils.spans import Spans


@dataclass
class TrainState:
    params: PolicyParams          # f32 master params
    opt_state: RMSPropState
    env_state: Any                # batched env state [B, ...]
    obs: torch.Tensor             # [B, N, n_s_max]
    fp: torch.Tensor              # [B, N, n_a_max]
    carry: Carry                  # [B, N, n_lstm] x2, compute dtype
    prev_done: torch.Tensor       # [B] f32
    generator: torch.Generator    # sampling noise and env resets
    step: int                     # global env-step counter
    # episode-return bookkeeping (global reward = sum over agents)
    ep_ret: torch.Tensor          # [B] running episode return
    ep_len: torch.Tensor          # [B]
    last_ep_ret: torch.Tensor     # [B] most recent completed episode return
    last_ep_len: torch.Tensor     # [B]


# the TrainState fields that hold one row per env (a data-parallel rank holds
# its rows of the global batch); the rest is replicated
PER_ENV_FIELDS = ("env_state", "obs", "fp", "carry", "prev_done", "ep_ret",
                  "ep_len", "last_ep_ret", "last_ep_len")


def state_leaves(ts: TrainState) -> List[torch.Tensor]:
    """The TrainState's tensors in a fixed order: params, the optimizer's
    running means, the env state, then the per-env fields."""
    return (tree_leaves(ts.params) + list(ts.opt_state.ms)
            + tree_leaves(ts.env_state)
            + [ts.obs, ts.fp, ts.carry.c, ts.carry.h, ts.prev_done,
               ts.ep_ret, ts.ep_len, ts.last_ep_ret, ts.last_ep_len])


def state_skeleton(ts: TrainState):
    """``ts``'s structure without its tensors, what ``state_from_leaves``
    reads of its ``like``."""
    zero = lambda _: 0
    return _Skeleton(tree_map(zero, ts.params),
                     RMSPropState(0, [0] * len(ts.opt_state.ms)),
                     tree_map(zero, ts.env_state))


class _Skeleton(NamedTuple):
    params: Any
    opt_state: RMSPropState
    env_state: Any


def state_from_leaves(like, leaves: List[torch.Tensor], step: int,
                      count: int, generator: torch.Generator) -> TrainState:
    """A TrainState of ``like``'s structure (a TrainState or its
    ``state_skeleton``) holding ``leaves`` (in ``state_leaves`` order),
    with the given host counters and generator."""
    it = iter(leaves)
    params = tree_map(lambda _: next(it), like.params)
    ms = [next(it) for _ in like.opt_state.ms]
    env_state = tree_map(lambda _: next(it), like.env_state)
    obs, fp, c, h, prev_done, ep_ret, ep_len, last_ret, last_len = it
    return TrainState(
        params=params, opt_state=RMSPropState(count, ms),
        env_state=env_state, obs=obs, fp=fp, carry=Carry(c, h),
        prev_done=prev_done, generator=generator, step=step, ep_ret=ep_ret,
        ep_len=ep_len, last_ep_ret=last_ret, last_ep_len=last_len)


def make_policy_spec(env_spec, mcfg: ModelConfig, agent: str) -> PolicySpec:
    return PolicySpec(
        n_agent=env_spec.n_agent,
        n_s_max=env_spec.n_s_max,
        n_a_max=env_spec.n_a_max,
        n_fc=mcfg.num_fc,
        n_lstm=mcfg.num_lstm,
        comm_type=AGENT_TO_COMM[agent],
        n_msg=mcfg.num_fc,
        sparse_comm=mcfg.sparse_comm,
        neighbor_obs=mcfg.neighbor_obs,
        obs_alpha=(env_spec.coop_gamma if env_spec.coop_gamma >= 0 else 1.0),
        neighbor_mask=env_spec.neighbor_mask,
        action_mask=env_spec.action_mask,
    )


class A2CFns(NamedTuple):
    init_state: Callable[..., TrainState]
    train_step: Callable[..., Tuple[TrainState, Dict[str, Any]]]
    eval_episode: Callable[..., Dict[str, Any]]
    record_episode: Callable[..., Dict[str, Any]]
    spec: PolicySpec
    optimizer: TF1RMSProp
    steps_per_update: int = 0  # global env steps one train_step consumes
    # the body train_step runs, eagerly or as a graph: (ts, schedule tensor
    # [beta, kick_w, lr], gumbel or None, generator) -> (ts', metrics)
    update: Optional[Callable] = None
    # train_step's CUDA graphs (jit on a card; their capture times), else
    # None
    graphed: Optional[GraphedStep] = None
    # the updates' spans and their reader (utils/spans.py): ``spans.read(n)``
    # for the last n updates, ``spans.means(n)`` each span's mean ms
    spans: Optional[Spans] = None


class _LoopState(NamedTuple):
    """What one rollout step hands to the next."""

    env_state: Any
    obs: torch.Tensor
    fp: torch.Tensor
    carry: Carry
    prev_done: torch.Tensor
    ep_ret: torch.Tensor
    ep_len: torch.Tensor
    last_ret: torch.Tensor
    last_len: torch.Tensor


def gumbel_noise(generator: torch.Generator, shape, device) -> torch.Tensor:
    """g = -log(-log U), U uniform in [tiny, 1): argmax(logits + g) samples
    the categorical, the law of ``jax.random.categorical``."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def _default_horizon(env) -> int:
    cfg = getattr(env, "cfg", None)
    if cfg is not None:
        if cfg.scenario.startswith("cacc"):
            return int(cfg.episode_length)
        return int(cfg.episode_steps_atsc)
    return 600


def make_a2c(env, mcfg: ModelConfig, tcfg: TrainConfig, agent: str = "ia2c",
             num_envs: Optional[int] = None, axis_name: Optional[str] = None,
             n_replicas: int = 1, jit: bool = True, device="cuda") -> A2CFns:
    """Build the A2C functions for one env + algorithm on ``device`` (the
    env must live on the same device).

    ``jit``: on a CUDA device, ``train_step`` runs each update as one
    replay of a CUDA graph (one graph for calls with ``gumbel`` and one
    without); ``jit=False`` issues every kernel from Python. On the CPU it
    changes nothing. A failed capture or replay raises.

    ``axis_name``: if set, this process is one rank of the default
    ``torch.distributed`` process group (``parallel/distributed.py``
    ``maybe_initialize``) holding ``num_envs`` envs, and ``n_replicas``
    must be the group's size: gradients and metrics are averaged over the
    ranks, and step counting and the lr/entropy schedules advance by GLOBAL
    env steps."""
    dev = resolve_device(device)
    if env.device.type != dev.type:
        raise ValueError(f"env lives on {env.device}, make_a2c asked for "
                         f"{dev}")
    dev = env.device
    rank = 0
    if axis_name is not None:
        if not torch.distributed.is_initialized():
            raise ValueError(
                f"axis_name={axis_name!r} needs the default process group: "
                "call deeprl_network_tpu_torch.parallel.distributed."
                "maybe_initialize() first (or use make_parallel_a2c)")
        if n_replicas != distributed.world_size():
            raise ValueError(
                f"n_replicas={n_replicas} but the process group has "
                f"{distributed.world_size()} ranks")
        rank = distributed.rank()
        if (jit and dev.type == "cuda"
                and torch.distributed.get_backend() == "gloo"):
            raise ValueError(
                "jit=True captures the update in a CUDA graph, and the gloo "
                "backend stages its all-reduce through the host, which a "
                "graph cannot hold: pass jit=False")
    cdt = torch.bfloat16 if mcfg.compute_dtype == "bfloat16" \
        else torch.float32
    if cdt != torch.float32 and not mcfg.fused_grad:
        raise ValueError("compute_dtype=bfloat16 is supported on the "
                         "default fused-gradient path only")
    # training-only reward shaping / kickstarting (see ModelConfig); an env
    # offers a hook by overriding the base class's method
    use_shaping = mcfg.switch_penalty > 0
    use_kick = mcfg.kickstart_coef > 0
    if (use_shaping or use_kick) and not mcfg.fused_grad:
        raise ValueError("switch_penalty / kickstart_coef are supported "
                         "on the default fused-gradient path only")
    if use_shaping and type(env).prev_action is Env.prev_action:
        raise ValueError(f"switch_penalty needs {type(env).__name__}."
                         "prev_action (ATSC envs only)")
    if use_kick and type(env).controller_action is Env.controller_action:
        raise ValueError(f"kickstart_coef needs {type(env).__name__}."
                         "controller_action (implemented by the ATSC "
                         "envs, hysteresis, and CACC, fixed-gain OVM)")
    kick_horizon = max(mcfg.kickstart_ratio * tcfg.total_step, 1.0)
    consensus = agent == "ia2c_cu"
    spec = make_policy_spec(env.spec, mcfg, agent)
    consts = policy_consts(spec, dev)
    n_env = num_envs or mcfg.num_envs
    # this rank's rows [row0, row0 + n_env) of the global batch
    n_global, row0 = n_env * n_replicas, rank * n_env
    wenv = AutoResetEnv(env, row0, n_global)
    T = mcfg.n_step
    D = torch.as_tensor(env.spec.spatial_discount(), device=dev)
    gamma = mcfg.gamma
    # one update consumes T steps x B envs x replicas GLOBAL env steps
    steps_per_update = T * n_global
    lr_env_sched = make_schedule(mcfg.lr_decay, mcfg.lr_init,
                                 tcfg.total_step, mcfg.lr_min)
    ent_sched = make_schedule(mcfg.entropy_decay, mcfg.entropy_coef,
                              tcfg.total_step, ratio=mcfg.entropy_ratio)
    optimizer = tf1_rmsprop(
        lambda count: lr_env_sched(count * steps_per_update),
        decay=mcfg.rmsp_alpha, eps=mcfg.rmsp_epsilon,
        max_grad_norm=mcfg.max_grad_norm)
    uniform_fp = init_fingerprint(spec, device=dev)
    n_agent, n_act = spec.n_agent, spec.n_a_max
    cons_tables = None
    if consensus:
        cons_tables = consensus_tables(
            env.spec.neighbor_mask,
            env.spec.action_mask if mcfg.consensus_masked else None,
            env.spec.obs_mask if mcfg.consensus_masked else None, dev)
    spans = Spans(T, dev, graph=jit and dev.type == "cuda",
                  allreduce=axis_name is not None)

    def _prep_params(params: PolicyParams) -> PolicyParams:
        """Masked (+ cast) params for the hot path: mask ONCE per update,
        then cast to the compute dtype; grads of the cast flow back to the
        f32 masters."""
        p = mask_comm_params(spec, params, consts)
        if cdt != torch.float32:
            p = tree_map(lambda t: t.to(cdt), p)
        return p

    def vpstep(params, carry, obs, fp, done):
        # inputs and carry follow the PARAMS' dtype (bf16 while training,
        # f32 in eval and record); logits/values go back to f32 for
        # sampling and the loss
        pdt = params.w_obs.w.dtype
        carry = Carry(carry.c.to(pdt), carry.h.to(pdt))
        carry2, logits, values = policy_step_batched(
            spec, params, carry, obs.to(pdt), fp.to(pdt), done, consts)
        return carry2, logits.float(), values.float()

    def init_state(seed: int = 0, params: Optional[PolicyParams] = None,
                   env_offset: Optional[int] = None) -> TrainState:
        """Fresh TrainState: params from ``seed`` unless given, env reset,
        zero carry, uniform fingerprints, and a device Generator seeded
        with ``seed`` for sampling and env resets. ``env_offset``, the
        global index of the state's first env, is this rank's (rank x
        ``num_envs``, 0 in one process): ``train_step`` draws for those
        rows, so no other value is accepted."""
        if env_offset is not None and env_offset != row0:
            raise ValueError(f"env_offset={env_offset}: this rank holds "
                             f"the envs from {row0}")
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        if params is None:
            params = init_policy_params(
                torch.Generator().manual_seed(seed), spec, device=dev)
        params = tree_map(lambda t: t.detach().to(dev, torch.float32),
                          params)
        env_state, obs = wenv.reset(n_env, gen)
        zeros = lambda: torch.zeros((n_env,), device=dev)
        return TrainState(
            params=params, opt_state=optimizer.init(tree_leaves(params)),
            env_state=env_state, obs=obs,
            fp=uniform_fp.expand(n_env, -1, -1).clone(),
            carry=init_carry(spec, n_env, cdt, dev),
            prev_done=torch.ones((n_env,), device=dev), generator=gen,
            step=0, ep_ret=zeros(), ep_len=zeros(), last_ep_ret=zeros(),
            last_ep_len=zeros())

    def _env_policy_step(mparams, st: _LoopState, g: torch.Tensor,
                         generator: torch.Generator, t: int):
        """The ONE rollout step both gradient paths share: policy forward,
        Gumbel-max sampling with the noise ``g``, env step + auto-reset,
        fingerprint refresh, episode bookkeeping. With autograd on, the
        logits, values and carry keep their graph (and, under ``remat``,
        the forward is checkpointed); everything that comes out of the env
        is a constant either way. ``t`` is the step's index in the window
        (its ``comm`` and ``env`` spans are marked where it is sampled)."""
        comm = embed_marks(lambda edge: (spans.begin if edge == "begin"
                                         else spans.end)("comm", t))
        if mcfg.remat and torch.is_grad_enabled():
            # no noise is drawn inside, so the RNG state need not be kept
            # (and a CUDA graph's capture may not read it); the comm span
            # is marked in the forward, not in the backward's recompute
            carry, logits, values = checkpoint(
                vpstep, mparams, st.carry, st.obs, st.fp, st.prev_done,
                use_reentrant=False, preserve_rng_state=False,
                context_fn=lambda: (comm, contextlib.nullcontext()))
        else:
            with comm:
                carry, logits, values = vpstep(mparams, st.carry, st.obs,
                                               st.fp, st.prev_done)
        with torch.no_grad():
            actions = torch.argmax(logits + g, dim=-1)
            new_fp = torch.softmax(logits, dim=-1)
            spans.begin("env", t)
            env_state, obs, reward, done, info = wenv.step(
                st.env_state, actions, generator)
            spans.end("env", t)
            done_f = done.float()
            # fingerprints reset to uniform on episode start
            new_fp = torch.where(done_f[:, None, None] > 0, uniform_fp,
                                 new_fp)
            ep_ret = st.ep_ret + reward.sum(-1)
            ep_len = st.ep_len + 1.0
            last_ret = torch.where(done_f > 0, ep_ret, st.last_ret)
            last_len = torch.where(done_f > 0, ep_len, st.last_len)
            ep_ret = ep_ret * (1.0 - done_f)
            ep_len = ep_len * (1.0 - done_f)
            rec = {"obs": st.obs, "fp": st.fp, "prev_done": st.prev_done,
                   "actions": actions, "logits": logits, "values": values,
                   "reward": reward, "done_f": done_f, "info": info,
                   "train_reward": reward}
            # training-only signals from the PRE-step env state (the phase
            # showing while a_t was chosen / the state the teacher scores).
            # Episode bookkeeping and eval stay on the TRUE reward.
            if use_shaping:
                switched = (actions != env.prev_action(st.env_state)).float()
                rec["train_reward"] = reward - mcfg.switch_penalty * switched
            if use_kick:
                teacher = env.controller_action(st.env_state)
        if use_kick:
            logp = torch.log_softmax(logits, dim=-1)
            rec["teacher_ce"] = -torch.gather(
                logp, -1, teacher[..., None])[..., 0]           # [B, N]
        new_st = _LoopState(env_state, obs, new_fp, carry, done_f, ep_ret,
                            ep_len, last_ret, last_len)
        return new_st, rec

    def _returns_pipeline(rew_seq, done_seq, v_boot):
        """normalize -> spatial mix -> n-step returns ([T, B, N])."""
        r = normalize_rewards(rew_seq, mcfg.reward_norm, mcfg.reward_clip)
        r = spatial_mix(r, D)
        return nstep_returns(r, done_seq, v_boot, gamma)

    def _rollout(mparams, ts: TrainState, gumbel, keys, generator):
        """T shared steps from ``ts``, drawing from ``generator``; the
        records named in ``keys`` (and the info series) as lists over
        time."""
        st = _LoopState(ts.env_state, ts.obs, ts.fp, ts.carry, ts.prev_done,
                        ts.ep_ret, ts.ep_len, ts.last_ep_ret, ts.last_ep_len)
        seqs: Dict[str, list] = {k: [] for k in keys}
        infos: Dict[str, list] = {}
        for t in range(T):
            spans.begin("step", t)
            g = (gumbel[t].to(dev) if gumbel is not None else
                 gumbel_noise(generator, (n_global, n_agent, n_act),
                              dev)[row0:row0 + n_env])
            st, rec = _env_policy_step(mparams, st, g, generator, t)
            if torch.is_grad_enabled():     # the fused path's loss terms
                rec["logp"], rec["ent"] = action_stats(rec["logits"],
                                                       rec["actions"])
            for k in keys:
                seqs[k].append(rec[k])
            for k, v in rec["info"].items():
                infos.setdefault(k, []).append(v)
            spans.end("step", t)
        extra = {"env/" + k: torch.mean(torch.stack(v).float())
                 for k, v in infos.items()}
        return st, {k: torch.stack(v) for k, v in seqs.items()}, extra

    def _fused_loss(ts, params, beta, kick_w, gumbel, generator):
        """Single-pass update: the loss is a function of the rollout itself,
        and gradients flow through the LSTM carry chain exactly as in the
        replay (same truncated-BPTT window)."""
        mparams = _prep_params(params)
        keys = ["logp", "ent", "values", "train_reward", "reward", "done_f"]
        if use_kick:
            keys.append("teacher_ce")
        st, seq, extra = _rollout(mparams, ts, gumbel, keys, generator)
        spans.end("rollout")
        spans.begin("returns")
        with torch.no_grad():
            _, _, v_boot = vpstep(mparams, st.carry, st.obs, st.fp,
                                  st.prev_done)
        returns = _returns_pipeline(seq["train_reward"], seq["done_f"],
                                    v_boot)
        advs = returns - seq["values"].detach()
        loss, stats = a2c_loss_terms(seq["logp"], seq["ent"], seq["values"],
                                     returns, advs, beta, mcfg.value_coef)
        extra["step_reward"] = torch.mean(seq["reward"].sum(-1))
        if use_kick:
            # CE toward the hand controller: mean per agent-step; the loss
            # term follows the sum-over-agents convention
            ce = seq["teacher_ce"]
            loss = loss + kick_w * torch.sum(torch.mean(ce, dim=(0, 1)))
            extra["kick_ce"] = torch.mean(ce.detach())
        return loss, stats, st, extra

    def _replay_loss(ts, params, beta, gumbel, generator):
        """Two-pass update: a rollout without gradients, then the policy
        run again over the recorded window for truncated BPTT."""
        with torch.no_grad():
            # mask per-edge comm blocks once per update, outside the loops
            mparams = mask_comm_params(spec, ts.params, consts)
            st, seq, extra = _rollout(
                mparams, ts, gumbel,
                ["obs", "fp", "prev_done", "actions", "reward", "values",
                 "done_f"], generator)
            spans.end("rollout")
            spans.begin("returns")
            _, _, v_boot = vpstep(mparams, st.carry, st.obs, st.fp,
                                  st.prev_done)
            returns = _returns_pipeline(seq["reward"], seq["done_f"], v_boot)
            advs = returns - seq["values"]
        roll = Rollout(obs=seq["obs"], fps=seq["fp"],
                       prev_dones=seq["prev_done"], actions=seq["actions"],
                       rewards=seq["reward"], values=seq["values"],
                       dones=seq["done_f"])
        loss, stats = a2c_loss(
            spec, mask_comm_params(spec, params, consts), ts.carry, roll,
            returns, advs, beta, mcfg.value_coef, remat=mcfg.remat,
            consts=consts)
        extra["step_reward"] = torch.mean(seq["reward"].sum(-1))
        return loss, stats, st, extra

    def _update(ts: TrainState, sched: torch.Tensor,
                gumbel: Optional[torch.Tensor], generator: torch.Generator
                ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """The update body: a function of tensors that reads nothing back
        to the host. ``sched`` [3] f32 holds the entropy coefficient, the
        kickstart weight and the learning rate; the draws come from
        ``generator``. The host counters of the returned state are those of
        ``ts`` advanced by one update (the wrapper sets them)."""
        spans.begin("update")
        spans.begin("rollout")
        beta, kick_w, lr = sched[0], sched[1], sched[2]
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(ts.params)]
        params = tree_unflatten(ts.params, leaves)
        if mcfg.fused_grad:
            loss, stats, st, extra = _fused_loss(ts, params, beta, kick_w,
                                                 gumbel, generator)
        else:
            loss, stats, st, extra = _replay_loss(ts, params, beta, gumbel,
                                                  generator)
        dev_metrics = {
            "loss": loss.detach(),
            "policy_loss": stats.policy.detach(),
            "value_loss": stats.value.detach(),
            "entropy": stats.entropy.detach(),
            "episode_return": torch.mean(st.last_ret),
            "episode_len": torch.mean(st.last_len),
            **extra,
        }
        spans.end("returns")
        spans.begin("backward")
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        spans.end("backward")
        if axis_name is not None:
            # the global batch mean: one all_reduce of the gradients and
            # the device-side metrics together
            spans.begin("allreduce")
            names = list(dev_metrics)
            out = distributed.all_reduce_mean(
                grads + [dev_metrics[k] for k in names])
            grads = out[:len(grads)]
            dev_metrics = dict(zip(names, out[len(grads):]))
            spans.end("allreduce")
        spans.begin("optimizer")
        grad_norm = global_norm(grads)
        updates, opt_state = optimizer.update(grads, ts.opt_state, lr=lr)
        new_params = tree_unflatten(
            ts.params, [(p.detach() + u).to(p.dtype)
                        for p, u in zip(leaves, updates)])
        if consensus:
            new_params = consensus_update(
                new_params, env.spec.neighbor_mask, tables=cons_tables)
        spans.end("optimizer")

        new_ts = TrainState(
            params=new_params, opt_state=opt_state, env_state=st.env_state,
            obs=st.obs, fp=st.fp,
            # truncated BPTT: the next window starts from a constant carry
            carry=Carry(st.carry.c.detach(), st.carry.h.detach()),
            prev_done=st.prev_done, generator=generator,
            step=ts.step + steps_per_update, ep_ret=st.ep_ret,
            ep_len=st.ep_len, last_ep_ret=st.last_ret,
            last_ep_len=st.last_len)
        spans.end("update")
        return new_ts, {**dev_metrics, "grad_norm": grad_norm}

    feed = HostScalars(3, dev)
    graphed = None
    skeleton: list = []           # the state's structure, from the first call
    if jit and dev.type == "cuda":
        def _flat_update(leaves, sched, extras, generator):
            ts = state_from_leaves(skeleton[0], leaves, 0, 0, generator)
            new_ts, metrics = _update(ts, sched, extras[0], generator)
            return state_leaves(new_ts), metrics

        graphed = GraphedStep(_flat_update, dev, n_scalars=3, spans=spans)

    def train_step(ts: TrainState, gumbel: Optional[torch.Tensor] = None
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        """One update. ``gumbel`` [T, B, N, A] (this rank's rows) replaces
        the sampling noise drawn from ``ts.generator`` (tests feed the JAX
        run's noise). ``ts`` is not written; its generator advances by the
        update's draws."""
        if gumbel is not None and tuple(gumbel.shape) != (
                T, n_env, env.spec.n_agent, env.spec.n_a_max):
            raise ValueError(f"gumbel has shape {tuple(gumbel.shape)}, the "
                             f"update draws [T, B, N, A] = "
                             f"{[T, n_env, env.spec.n_agent, n_act]}")
        with spans.host("train_step"):
            with spans.host("schedule"):
                beta = ent_sched(ts.step)
                # kickstart weight anneals linearly to 0 at
                # kickstart_ratio * total_step
                kick_w = mcfg.kickstart_coef * min(max(
                    1.0 - ts.step / kick_horizon, 0.0), 1.0)
                sched = (beta, kick_w,
                         optimizer.lr_schedule(ts.opt_state.count))
            if graphed is None:
                with spans.host("scalars_write"):
                    sched_t = feed.tensor(sched)
                with spans.host("launch"):
                    new_ts, metrics = _update(ts, sched_t, gumbel,
                                              ts.generator)
            else:
                if not skeleton:
                    skeleton.append(state_skeleton(ts))
                leaves, metrics = graphed(gumbel is not None,
                                          state_leaves(ts), sched, [gumbel],
                                          ts.generator)
                new_ts = state_from_leaves(
                    ts, leaves, ts.step + steps_per_update,
                    ts.opt_state.count + 1, ts.generator)
            metrics = {**metrics, "lr": lr_env_sched(ts.step), "beta": beta}
        spans.commit()
        return new_ts, metrics

    def _episode_start(params, seed_or_generator):
        """(masked f32 params, generator, env state, obs, carry, fp) of one
        env instance at the start of an episode."""
        if params is not None:
            params = mask_comm_params(
                spec, tree_map(lambda t: t.detach(), params), consts)
        gen = seed_or_generator
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(gen))
        state, obs = env.reset(1, gen)
        return (params, gen, state, obs,
                init_carry(spec, 1, torch.float32, dev), uniform_fp[None])

    def _act(logits, greedy, gumbel_t, gen):
        if greedy:
            return torch.argmax(logits, dim=-1)
        g = (gumbel_t.to(dev) if gumbel_t is not None else
             gumbel_noise(gen, (1, n_agent, n_act), dev))
        return torch.argmax(logits + g, dim=-1)

    @torch.no_grad()
    def eval_episode(params: PolicyParams,
                     seed_or_generator: Union[int, torch.Generator],
                     max_steps: Optional[int] = None, greedy: bool = False,
                     gumbel: Optional[torch.Tensor] = None
                     ) -> Dict[str, torch.Tensor]:
        """One evaluation episode on a single env instance. Default is
        SAMPLED actions, the reference's evaluation protocol (argmax is much
        worse for these stochastic-mixing controllers); ``gumbel``
        [horizon, N, A] replaces the sampling noise. The loop runs the whole
        horizon and weighs every step by ``alive``, so the per-step metrics
        average over EXECUTED steps only."""
        horizon = max_steps or _default_horizon(env)
        params, gen, state, obs, carry, fp = _episode_start(
            params, seed_or_generator)
        no_done = torch.zeros((1,), device=dev)
        ep_ret = torch.zeros((), device=dev)
        alive = torch.ones((), device=dev)
        seq: Dict[str, list] = {"alive": []}
        for t in range(horizon):
            carry, logits, _ = vpstep(params, carry, obs, fp, no_done)
            action = _act(logits, greedy,
                          None if gumbel is None else gumbel[t][None], gen)
            fp = torch.softmax(logits, dim=-1)
            state, obs, reward, done, info = env.step(state, action)
            ep_ret = ep_ret + reward.sum() * alive
            seq["alive"].append(alive)
            for k, v in info.items():
                seq.setdefault(k, []).append(v[0] * alive)
            alive = alive * (1.0 - done[0].float())
        n_alive = torch.stack(seq.pop("alive")).sum()
        ep_len = torch.clamp(n_alive, min=1.0)
        out = {"episode_return": ep_ret, "episode_len": n_alive,
               "avg_step_reward": ep_ret / ep_len}
        for k, v in seq.items():
            # per-step mean over any agent axes, then weighted by executed
            # steps only
            per_step = torch.stack(v).float().reshape(horizon, -1).mean(-1)
            out["env/" + k] = per_step.sum() / ep_len
        return out

    @torch.no_grad()
    def record_episode(params: Optional[PolicyParams],
                       seed_or_generator: Union[int, torch.Generator],
                       max_steps: Optional[int] = None,
                       policy: str = "greedy",
                       gumbel: Optional[torch.Tensor] = None
                       ) -> Dict[str, torch.Tensor]:
        """One episode with full per-step measurement series, each
        [horizon, ...]. policy: 'greedy' (argmax), 'sample', or
        'controller' (the env's strongest built-in hand controller,
        ``env.controller_action``, falling back to ``greedy_action``;
        needs no params and leaves the fingerprints unchanged)."""
        if policy not in ("greedy", "sample", "controller"):
            raise ValueError(f"unknown record policy {policy!r}")
        horizon = max_steps or _default_horizon(env)
        params, gen, state, obs, carry, fp = _episode_start(
            params, seed_or_generator)
        no_done = torch.zeros((1,), device=dev)
        alive = torch.ones((), device=dev)
        seq: Dict[str, list] = {}
        for t in range(horizon):
            if policy == "controller":
                action = env.controller_action(state)
                if action is None:
                    action = env.greedy_action(state)
            else:
                carry, logits, _ = vpstep(params, carry, obs, fp, no_done)
                action = _act(logits, policy == "greedy",
                              None if gumbel is None else gumbel[t][None],
                              gen)
                fp = torch.softmax(logits, dim=-1)
            state, obs, reward, done, info = env.step(state, action)
            step_out = {"action": action, "reward": reward,
                        **env.record(state), **info}
            seq.setdefault("alive", []).append(alive)
            for k, v in step_out.items():
                seq.setdefault(k, []).append(v[0])
            alive = alive * (1.0 - done[0].float())
        return {k: torch.stack(v) for k, v in seq.items()}

    return A2CFns(init_state=init_state, train_step=train_step,
                  eval_episode=eval_episode, record_episode=record_episode,
                  spec=spec, optimizer=optimizer,
                  steps_per_update=steps_per_update, update=_update,
                  graphed=graphed, spans=spans)
