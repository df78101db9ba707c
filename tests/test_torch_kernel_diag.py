"""kernel_diag.py's ablation: every patch finds its one line of
newton_doc.cuh (where B1's and B3's bodies live) and every plan list of
stages.cu, and any patched line that changed is refused rather than
skipped."""

import pytest

import kernel_diag as kd
from strutopy_tpu_torch.ops import build


def _bodies():
    return (build.CSRC / "newton_doc.cuh").read_text()


def _stages():
    return (build.CSRC / "stages.cu").read_text()


def test_every_ablation_patch_applies_once():
    out = kd.ablated_source(_bodies())
    for _bit, _what, subs in kd.PARTS:
        for _old, new in subs:
            assert out.count(new) == 1, new
    bits = sum(bit for bit, _what, _subs in kd.PARTS)
    assert all(v & ~bits == 0 for v in kd.VARIANTS)
    assert kd.describe(0) == "nothing (the kernel)"


@pytest.mark.parametrize("old", [old for _bit, _what, subs in kd.PARTS for old, _new in subs])
def test_a_changed_patched_line_is_refused(old):
    with pytest.raises(RuntimeError, match="no longer holds"):
        half = len(old) // 2
        kd.ablated_source(_bodies().replace(old, old[:half] + "/**/" + old[half:]))


@pytest.mark.parametrize("i", range(kd.N_PLANS))
def test_each_plan_candidate_replaces_its_lists(i):
    out = kd.planned_source(_stages(), i)
    for old, cands in kd.PLAN_LISTS.values():
        assert old not in out
        head = old.split("{{")[0]
        assert out.count(head + "{{%d, %d, %d}};" % cands[i]) == 1
    # the list the kernels are built from is its first candidate
    for old, cands in kd.PLAN_LISTS.values():
        assert old.split("= {")[1].startswith("{%d, %d, %d}" % cands[0])


@pytest.mark.parametrize("which", sorted(kd.PLAN_LISTS))
def test_a_changed_plan_list_is_refused(which):
    old = kd.PLAN_LISTS[which][0]
    with pytest.raises(RuntimeError, match="no longer holds"):
        kd.planned_source(_stages().replace(old, old.replace("}};", "}, };")), 0)
