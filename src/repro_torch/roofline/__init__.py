"""The planner's roofline terms (:mod:`repro_torch.roofline.analyze`) and
tables (:mod:`repro_torch.roofline.report`)."""
