"""Executable entry points of the port, the analogues of the reference's
binaries (CMakeLists.txt:59-105):

  python -m mcptam_tpu_torch.apps.mcptam   (standalone tracker and mapper)
  python -m mcptam_tpu_torch.apps.client   (on-board tracker of the client/server split)
  python -m mcptam_tpu_torch.apps.server   (off-board map server)
  python -m mcptam_tpu_torch.apps.camera_calibrator  (intrinsics from board views)
  python -m mcptam_tpu_torch.apps.pose_calibrator    (rig extrinsics)

Headless and file-driven: rig configs are JSON (io/rig_config.py), video is
a (C,T,H,W) uint8 .npy/.npz or a dataset directory (io/dataset.py),
replayed through the native synchronised frame queue; the calibrators
read (T,H,W) and (C,T,H,W) uint8 board views.  The apps run on the
GPU unless ``--device cpu`` is given.
"""
