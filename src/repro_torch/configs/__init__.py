"""Architecture configurations: ``base.ArchConfig`` and one module per
assigned architecture, field for field the reference's ``repro.configs``."""
