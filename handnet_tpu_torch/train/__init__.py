"""Training for the port: ``schedules`` (learning-rate schedules as plain
functions of the update count), ``trainer`` (``TrainState``,
``make_optimizer``, ``FCOSTrainer``) and ``checkpoints``
(``CheckpointManager``, the flax-keyed params npz). Import submodules
directly; nothing is loaded here."""
