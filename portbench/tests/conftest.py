"""Puts the checkout root on the path, so ``portbench`` imports as a
package whichever directory pytest starts from."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
