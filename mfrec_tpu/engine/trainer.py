'''
Convergence drivers.

The reference's epoch rule (``gd_estimator.pyx:360,455,545``):

    while (epoch < min_epochs) or (rmse <= rmse_last - min_improvement):

with rmse initialized to 2.0 — i.e. train at least ``min_epochs`` epochs and
keep going while the training RMSE still improves by ``min_improvement``.
Only ``estimator_loop`` (:264) also honors ``max_epochs``; here every driver
honors it as a safety cap (documented deviation — set it high to reproduce
uncapped reference behavior).

The device kernels are epoch-granular jitted functions; the improvement
test runs on host between epochs (one scalar device->host sync per epoch).
'''
from __future__ import annotations


class ConvergenceDriver:
    '''Stateful epoch loop with the reference's improvement rule and an
    rmse history (reference ``rmse_history``: ``gradient_descent.py:93,114``).'''

    def __init__(self, min_epochs, max_epochs, min_improvement,
                 nan_guard=True, plateau_decay=1.0, min_lr_scale=0.01):
        self.min_epochs = int(min_epochs)
        self.max_epochs = int(max_epochs)
        self.min_improvement = float(min_improvement)
        self.nan_guard = nan_guard
        self.history = []
        # Plateau-onset learning-rate decay: when the improvement rule
        # would stop, multiply ``lr_scale`` by ``plateau_decay`` and keep
        # training instead — until the scale floors at ``min_lr_scale``
        # (then the reference stop rule applies unchanged).  Measured at
        # ML-10M: decay FROM the plateau breaks below the constant-rate
        # trajectory, while decay from epoch 0 loses everywhere — so this
        # is the only decay shape worth turning on.  1.0 disables (the
        # reference semantics, and the shipped default).
        self.plateau_decay = float(plateau_decay)
        self.min_lr_scale = float(min_lr_scale)
        self.lr_scale = 1.0

    def _plateau_step(self):
        '''One decay step at a stall; True = keep training.'''
        if self.plateau_decay >= 1.0 or self.lr_scale <= self.min_lr_scale:
            return False
        self.lr_scale = max(self.lr_scale * self.plateau_decay,
                            self.min_lr_scale)
        return True

    def run(self, epoch_fn, state):
        '''epoch_fn(state) -> (state, rmse_scalar).  Returns final state.
        ``epoch_fn`` may read ``self.lr_scale`` (the plateau-decay knob);
        it is only ever updated between epochs.'''
        import math
        rmse = 2.0
        rmse_last = rmse      # min_epochs=0 means converge-only, not crash
        epoch = 0
        while (epoch < self.min_epochs
               or rmse <= rmse_last - self.min_improvement
               or self._plateau_step()):
            if epoch >= self.max_epochs:
                break
            rmse_last = rmse
            state, rmse_dev = epoch_fn(state)
            rmse = float(rmse_dev)
            if self.nan_guard and not math.isfinite(rmse):
                raise FloatingPointError(
                    'training diverged: rmse=%r at epoch %d (reduce the '
                    'learning rate or batch size)' % (rmse, epoch))
            self.history.append(rmse)
            epoch += 1
        return state


class ResilientDriver(ConvergenceDriver):
    '''Failure-detecting, self-recovering epoch loop.

    The reference has no failure detection at all (SURVEY §5: bare
    ``try/except`` swallowing, ``base.py:249-255``) and the survey scoped
    it to "rely on checkpoint/resume".  This driver goes further: a
    failed epoch — non-finite RMSE, or RMSE blowing past
    ``blowup_factor`` x the best seen — is detected, the factor state is
    rolled back to the last good snapshot, the epoch function is rebuilt
    at a backed-off learning rate, and training resumes.  With
    ``checkpoint_dir`` set, snapshots also go to disk (orbax-style), so
    a killed process resumes from the last good epoch instead of epoch 0.

    ``run(epoch_factory, state)``: ``epoch_factory(lr_scale)`` returns an
    ``epoch_fn(state) -> (state, rmse)``; it is re-invoked with a smaller
    ``lr_scale`` after each recovery (a deterministic diverging epoch
    replayed unchanged would diverge again).
    '''

    def __init__(self, min_epochs, max_epochs, min_improvement,
                 snapshot_every=5, blowup_factor=4.0, backoff=0.5,
                 max_retries=2, checkpoint_dir=None, state_guard=None):
        super().__init__(min_epochs, max_epochs, min_improvement,
                         nan_guard=False)
        self.snapshot_every = max(1, int(snapshot_every))
        self.blowup_factor = float(blowup_factor)
        self.backoff = float(backoff)
        self.max_retries = int(max_retries)
        self.checkpoint_dir = checkpoint_dir
        # RMSE alone cannot catch clamped-prediction divergence: the
        # error stays bounded by the rating range while the factors blow
        # through f32 overflow, so by the time NaN reaches the RMSE the
        # snapshots are already poisoned.  state_guard(state) -> bool
        # inspects the state itself (finite + bounded magnitude).
        self.state_guard = state_guard
        self.recoveries = 0
        self.lr_scale = 1.0

    # -- snapshotting -----------------------------------------------------
    def _host_copy(self, state):
        import jax
        import numpy as np
        return jax.tree.map(np.array, state)

    def _persist(self, state, epoch):
        if self.checkpoint_dir is None:
            return
        from mfrec_tpu.engine.checkpoint import save_state_orbax
        save_state_orbax(self.checkpoint_dir,
                         {'state': state, 'epoch': epoch,
                          'history': list(self.history),
                          'lr_scale': self.lr_scale})

    def load_snapshot(self, like=None):
        '''Resume support: the last persisted {state, epoch, history,
        lr_scale} dict, or None if nothing was persisted.'''
        if self.checkpoint_dir is None:
            return None
        import os
        from mfrec_tpu.engine.checkpoint import load_state_orbax
        if not os.path.exists(self.checkpoint_dir):
            return None
        return load_state_orbax(self.checkpoint_dir, like=like)

    def _failed(self, rmse, best):
        import math
        if not math.isfinite(rmse):
            return True
        return (best is not None
                and rmse > self.blowup_factor * max(best, 1e-6))

    @staticmethod
    def _coerce_state(restored, like):
        '''Rebuild ``restored`` with ``like``'s container types (orbax
        round-trips tuples as lists) — returns None when leaf count or
        any leaf shape disagrees (a stale checkpoint from a different
        model/rank must not be silently loaded).'''
        import jax
        import numpy as np
        leaves = jax.tree.leaves(restored)
        want = jax.tree.leaves(like)
        if len(leaves) != len(want) or any(
                np.shape(x) != np.shape(y)
                or np.asarray(x).dtype != np.asarray(y).dtype
                for x, y in zip(leaves, want)):
            return None
        return jax.tree.unflatten(jax.tree.structure(like), leaves)

    def run(self, epoch_factory, state, resume=True):
        '''Train to convergence with rollback recovery; returns the
        final state.  ``self.recoveries`` counts rollbacks taken,
        ``self.lr_scale`` the final learning-rate scale.

        With ``checkpoint_dir`` set and ``resume`` true (the default), a
        compatible on-disk snapshot is loaded first, so a killed process
        continues from the last good epoch instead of epoch 0 — the
        crash-resume promise above.  An incompatible or unreadable
        snapshot logs a warning and trains fresh (then overwrites it at
        the next snapshot point).'''
        good_state = self._host_copy(state)
        good_epoch = 0
        good_hist_len = 0
        rmse, rmse_last = 2.0, 2.0
        best = None
        epoch = 0
        if resume and self.checkpoint_dir is not None:
            import logging
            log = logging.getLogger(__name__)
            snap = None
            try:
                snap = self.load_snapshot()
            except Exception as exc:
                log.warning('resilient resume: unreadable checkpoint at '
                            '%s (%s) — training fresh',
                            self.checkpoint_dir, exc)
            if snap is not None:
                coerced = self._coerce_state(snap['state'], state)
                if coerced is not None:
                    state = coerced
                    good_state = self._host_copy(state)
                    good_epoch = epoch = int(snap['epoch'])
                    self.history = [float(x) for x in snap['history']]
                    good_hist_len = len(self.history)
                    self.lr_scale = float(snap['lr_scale'])
                    rmse = self.history[-1] if self.history else 2.0
                    rmse_last = float('inf')   # run >=1 epoch post-resume
                    best = min(self.history) if self.history else None
                    log.info('resilient resume: continuing from epoch %d '
                             '(rmse %.6g, lr scale %g) at %s', epoch, rmse,
                             self.lr_scale, self.checkpoint_dir)
                else:
                    log.warning('resilient resume: checkpoint at %s does '
                                'not match the model state (different '
                                'shape/structure) — training fresh',
                                self.checkpoint_dir)
        epoch_fn = epoch_factory(self.lr_scale)
        while (epoch < self.min_epochs
               or rmse <= rmse_last - self.min_improvement):
            if epoch >= self.max_epochs:
                break
            rmse_last = rmse
            state, rmse_dev = epoch_fn(state)
            rmse = float(rmse_dev)
            if (self._failed(rmse, best)
                    or (self.state_guard is not None
                        and not self.state_guard(state))):
                if self.recoveries >= self.max_retries:
                    raise FloatingPointError(
                        'training diverged: rmse=%r at epoch %d and the '
                        '%d recovery attempts are exhausted'
                        % (rmse, epoch, self.max_retries))
                self.recoveries += 1
                self.lr_scale *= self.backoff
                epoch_fn = epoch_factory(self.lr_scale)
                state = good_state
                del self.history[good_hist_len:]
                epoch = good_epoch
                rmse = self.history[-1] if self.history else 2.0
                rmse_last = rmse + 2.0 * self.min_improvement + 1.0
                # best must rewind with the history: keeping the lower
                # best from the discarded trajectory makes healthy
                # post-rollback epochs trip the blowup test and exhausts
                # max_retries on a converging run
                best = min(self.history) if self.history else None
                continue
            self.history.append(rmse)
            best = rmse if best is None else min(best, rmse)
            epoch += 1
            if epoch % self.snapshot_every == 0:
                good_state = self._host_copy(state)
                good_epoch = epoch
                good_hist_len = len(self.history)
                self._persist(good_state, epoch)
        return state
