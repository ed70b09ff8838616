"""repro_torch.train — a port of ``repro.train``.

* ``checkpoint`` — atomic, retained checkpoints of nested dicts, lists and
  tuples of tensors, numpy arrays and scalars, in the reference's on-disk
  format (a checkpoint written by either package restores in the other);
  ``restore(like=)`` puts each leaf on its ``like`` leaf's device and
  dtype.
* ``fault`` — the restart ``Supervisor`` (chaos-injected
  ``WorkerFailure``s resume from the latest checkpoint) and the straggler
  ``BackupTaskPolicy``.
* ``elastic`` — ``reshard_checkpoint`` and ``bc_elastic_nb``, the paper's
  n_b = c·m/n for a new processor count.

* ``train_lib`` — the LM train step (``make_lm_train_step``: loss and
  gradient, optional compression, AdamW updating the state in place),
  the family-agnostic ``make_generic_train_step``, and
  ``state_from_reference`` / ``state_to_numpy``, which carry a train
  state to and from the reference's tree bit for bit.

``launch.bc_run --ckpt-dir`` saves the exact sweep's cumulative λ here
after every batch; ``launch.train --ckpt-dir`` saves the train state.
"""
