"""Training for the port: ``schedules`` (learning-rate schedules as plain
functions of the update count), ``trainer`` (``TrainState``,
``make_optimizer``, ``A2JTrainer``, ``FCOSTrainer``), ``pose2mesh_loss``
(Pose2Mesh's loss bundle) and ``checkpoints`` (``CheckpointManager``, the
flax-keyed params npz). Import submodules directly; nothing is loaded
here."""
