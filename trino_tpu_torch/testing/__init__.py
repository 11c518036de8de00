"""Test support: the sqlite correctness oracle and the chaos harness.

The port of the reference ``testing/`` package (the role of the
reference's ``testing/trino-testing`` module family): shipped in the
package, not in tests/, so a user of the port gets the same harness.
``oracle.py`` checks rows against sqlite; ``chaos.py`` drives the
distributed runner under seeded faults.
"""
