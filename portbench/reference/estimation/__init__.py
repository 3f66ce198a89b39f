"""Estimation layer, batch-first: fixed-foot detection and contact-aided
legged odometry (PyTorch counterpart of `cmw_tpu/estimation/`; BLF
`Contacts::FixedFootDetector` and `Estimators::LeggedOdometry`,
WholeBodyQPBlock.cpp:92-129,263-320)."""
