"""handnet_tpu_torch — the PyTorch/CUDA port of ``handnet_tpu``.

The JAX package ``handnet_tpu`` is the reference; this package mirrors its
layout (``config``, ``nn/``, ``ops/``, ``models/``, ``convert/``) so each
module's counterpart is found by path. It imports torch and numpy only.

The serving forward ``models.pipeline.HandNetPipeline`` runs the fused
frame -> joints path, in float or int8 (``nn.quant``). The two kernels the JAX
package wrote in Pallas for the TPU are hand-written CUDA C++ for Hopper
(``csrc/*.cu``), built with ``nvcc`` at first use by ``kernels.build`` and
wrapped in ``ops.cuda_gn`` (GroupNorm: the statistics kernel, and the
normalize, affine and ReLU pass that XLA fuses for the JAX package) and
``ops.cuda_a2j`` (A2J anchor decode); ``ops.cuda_int8_conv`` computes the int8
convolutions that XLA computes for the JAX package. A wrapper given a CPU
tensor runs its plain PyTorch version; given a CUDA tensor it launches the
kernel or raises. Each kernel is a ``torch.library`` op
(``torch.ops.handnet_torch.*``), so ``torch.export`` records it.

Serving: ``apps.serve.PipelineServer`` (the streaming server, one CUDA
graph per batch bucket from ``graphs``) and ``export`` (the deployment
artifact: one ``torch.export`` program per bucket, loaded without model
code), with the CLIs ``apps.serve`` and ``apps.export_pipeline``.

Training: ``train.trainer.FCOSTrainer`` (the detector's train step, K2s and
K2a in its forward, their ops' registered gradients in its backward),
``train.trainer.A2JTrainer`` (A2J's train step; its eval step decodes
through K1), ``apps.train_pose2mesh`` (Pose2Mesh's, with
``train.pose2mesh_loss``), ``train.schedules`` and ``train.checkpoints``.

Data parallel: ``parallel`` (``create_mesh``, ``init_data_parallel``,
``shard_batch``, ``replicate``): the trainers' ``mesh`` trains through
``DistributedDataParallel`` with global BatchNorm statistics and loss
normalizers, the training CLIs run under ``torchrun``, and
``PipelineServer(mesh=...)`` shards every bucket over the cards of one
process.
"""

__version__ = "0.1.0"
