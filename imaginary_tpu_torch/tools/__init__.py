"""Developer tooling that ships inside the package so the gate can run it
anywhere the package imports — no third-party installs, no skip path.

`itpucheck` is the project-invariant static analyzer (stdlib `ast` only);
`rules/` holds one thin module per rule. See README "Static analysis".
"""
