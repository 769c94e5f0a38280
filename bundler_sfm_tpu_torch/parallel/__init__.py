"""Multi-device paths on `torch.distributed` — port of
`bundler_sfm_tpu/parallel/`: process-group helpers (`mesh`), the
image-sharded ring matcher and the pair-sharded matcher
(`matching_sharded`), and point-sharded bundle adjustment
(`ba_sharded`).  One process is one rank on one device."""
