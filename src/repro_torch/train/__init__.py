"""repro_torch.train — the fault-tolerance half of ``repro.train``.

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

``launch.bc_run --ckpt-dir`` saves the exact sweep's cumulative λ here
after every batch. The model-training half of ``repro.train``
(``train_lib``) is not ported.
"""
