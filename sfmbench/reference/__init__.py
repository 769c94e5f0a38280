"""The plain reference that decides `correct`: plain NumPy / PyTorch,
importing neither JAX nor the program under test (`bundler_sfm_tpu_torch`).

  matching  — exact 2-NN, the ratio test and the keep-first dedup of
              KeyMatchFull, one image pair at a time
  bundle    — a `bundle.out` reader and its scoring against the scene's
              ground truth (reprojection, similarity ATE)
"""
