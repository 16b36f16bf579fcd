"""SO(3) algebra, IGSO(3) expansions and tables, and the IPA attention kernel."""
