"""Entry points of the port: ``serve`` (the streaming server),
``export_pipeline`` (the deployment artifact's CLI) and
``train_pose2mesh`` (Pose2Mesh training). Nothing is loaded here."""
