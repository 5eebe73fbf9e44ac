"""The paper's two applications (§5.2): SUMMA and BPMF."""
