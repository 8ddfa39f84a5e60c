"""Faults planted in the timed path, to show that the correctness check
fails them: each is a context manager that breaks the program (or one of
its ranks) while it is built and run. The benchmark's own runs never use
them; ``calibrate.py`` reads them on the card and the tests on the CPU.

- ``unchanged``: ``train_step`` hands back the state it was given.
- ``half_batch``: the loss is the mean over the first half of the batch.
- ``token``: the sampled action of every sixteenth row is drawn with its
  noise shifted by one action (an altered token, where it is produced).
- ``carry_kept``: the policy's LSTM carry is not masked where an episode
  ended, so it flows into the next episode.
- ``stale_obs``: the auto-reset hands back the ended episode's last
  observation in place of the fresh episode's first.

Faults of one comm family's own mechanism, for that family:

- ``fp_zeroed``: the policy reads zeros in place of the fingerprints (FP).
- ``commnet_sum``: CommNet's message is the neighbours' sum in place of
  their mean.
- ``dial_no_bias``: DIAL's message head drops its bias b_dial.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name: str, new):
    old = getattr(module, name)
    setattr(module, name, new)
    try:
        yield
    finally:
        setattr(module, name, old)


def unchanged():
    from benchmark import program
    real = program.build

    def build(*args, **kw):
        env, fns = real(*args, **kw)
        return env, fns._replace(train_step=lambda ts, gumbel=None: (
            ts, {"loss": torch.zeros(())}))
    return _patched(program, "build", build)


def half_batch():
    from deeprl_network_tpu_torch.utils import rollout
    real = rollout.a2c_loss_terms

    def terms(logp_a, entropy, values, returns, advs, beta, value_coef):
        h = max(logp_a.shape[1] // 2, 1)
        return real(logp_a[:, :h], entropy[:, :h], values[:, :h],
                    returns[:, :h], advs[:, :h], beta, value_coef)
    return _patched(rollout, "a2c_loss_terms", terms)


def token():
    from deeprl_network_tpu_torch.utils import rollout
    real = rollout.gumbel_noise

    def noise(generator, shape, device):
        g = real(generator, shape, device)
        rows = torch.arange(shape[0], device=g.device) % 16 == 0
        return torch.where(rows.reshape((-1,) + (1,) * (g.ndim - 1)),
                           g.roll(1, dims=-1), g)
    return _patched(rollout, "gumbel_noise", noise)


def carry_kept():
    from deeprl_network_tpu_torch.utils import rollout
    real = rollout.policy_step_batched

    def step(spec, params, carry, obs, fp, done, consts):
        return real(spec, params, carry, obs, fp, torch.zeros_like(done),
                    consts)
    return _patched(rollout, "policy_step_batched", step)


def stale_obs():
    from deeprl_network_tpu_torch.envs import wrappers

    def step(self, state, action, generator=None):
        s2, obs2, reward, done, info = self.env.step(state, action)
        rs, _ = self.reset(action.shape[0], generator)
        return wrappers._tree_where(done, rs, s2), obs2, reward, done, info
    return _patched(wrappers.AutoResetEnv, "step", step)


def _policy_step(change):
    """The policy step with its params, consts and fingerprints changed by
    ``change``."""
    from deeprl_network_tpu_torch.utils import rollout
    real = rollout.policy_step_batched

    def step(spec, params, carry, obs, fp, done, consts):
        params, consts, fp = change(params, consts, fp)
        return real(spec, params, carry, obs, fp, done, consts)
    return _patched(rollout, "policy_step_batched", step)


def fp_zeroed():
    return _policy_step(lambda p, c, fp: (p, c, torch.zeros_like(fp)))


def commnet_sum():
    return _policy_step(lambda p, c, fp: (
        p, c._replace(deg=torch.ones_like(c.deg)), fp))


def dial_no_bias():
    return _policy_step(lambda p, c, fp: (
        p._replace(w_dial=p.w_dial._replace(
            b=torch.zeros_like(p.w_dial.b))), c, fp))


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "token": token,
          "carry_kept": carry_kept, "stale_obs": stale_obs,
          "fp_zeroed": fp_zeroed, "commnet_sum": commnet_sum,
          "dial_no_bias": dial_no_bias}
