"""Evaluation metrics of the port (an own copy of the JAX package's
ops/metrics.py:28-293, which follows the upstream eval_utils.py):

- ARI and FG-ARI by the one-hot contingency formulation, its degenerate
  cases (both partitions trivial) scoring 1.0;
- Hungarian-matched mIoU and FG-mIoU, with the undetected-object penalty;
- mBO, the mean best overlap of each foreground object;
- `postproc_mask`, the background-aware argmax;
- MSE (summed per image), PSNR, and SSIM in skimage's Gaussian variant;
- the COCO overlap preprocessing (`preproc_masks_overlap`, the DINOSAUR
  protocol): with an `inst_overlap_mask`, every segmentation metric
  first moves the pixels covered by more than one ground-truth instance
  to the ground truth's background and to a fresh predicted class (one
  past the image's largest), which takes them out of every matching.

Masks are integer tensors (or numpy arrays). The contingency tables are
counted with `torch.bincount` on the masks' device and held in float64, so
every count is exact and every score equals the JAX package's float64
numpy. The Hungarian matching runs on the host with
`scipy.optimize.linear_sum_assignment`, as in the JAX package.
`masks_to_boxes` gives each slot id's box in a frame, at once over
every frame and id.
"""

import numpy as np
import torch
from scipy.ndimage import gaussian_filter
from scipy.optimize import linear_sum_assignment

FG_THRE = 0.5


def _ids(x):
    """Integer masks as an int64 tensor (on their device)."""
    t = torch.as_tensor(x)
    if t.dtype.is_floating_point or t.dtype == torch.bool:
        raise TypeError(f"need integer masks, got {t.dtype}")
    return t.long()


def contingency(true_ids, pred_ids, num_true, num_pred):
    """[B, P] true and predicted ids -> [B, num_true, num_pred] float64
    counts of the pixels with each (true, pred) pair."""
    B = true_ids.shape[0]
    offset = torch.arange(B, device=true_ids.device)[:, None] * \
        (num_true * num_pred)
    flat = (offset + true_ids * num_pred + pred_ids).reshape(-1)
    counts = torch.bincount(flat, minlength=B * num_true * num_pred)
    return counts.reshape(B, num_true, num_pred).double()


###########################################
# COCO overlap preprocessing
###########################################


def preproc_masks_overlap(gt_mask, pred_mask, inst_overlap_mask=None):
    """One image's integer masks with the pixels of `inst_overlap_mask`
    (covered by more than one ground-truth instance) set to 0 in the
    ground truth and to pred.max() + 1 in the prediction; unchanged
    without a mask. -> (gt, pred) int64 tensors on gt's device."""
    if inst_overlap_mask is None:
        return gt_mask, pred_mask
    gt, pred = _apply_overlap(_ids(gt_mask)[None], _ids(pred_mask)[None],
                              torch.as_tensor(inst_overlap_mask)[None])
    return gt[0], pred[0]


def _apply_overlap(gt_mask, pred_mask, inst_overlap_mask):
    """`preproc_masks_overlap` of each image of [B, ...] masks, the fresh
    class one past each image's own largest predicted id."""
    if inst_overlap_mask is None:
        return gt_mask, pred_mask
    gt = _ids(gt_mask).clone()
    pred = _ids(pred_mask).to(gt.device)
    B = gt.shape[0]
    ov = torch.as_tensor(inst_overlap_mask).to(gt.device).bool().reshape(
        gt.shape)
    fresh = (pred.reshape(B, -1).max(1).values + 1).reshape(
        B, *[1] * (pred.dim() - 1))
    gt[ov] = 0
    return gt, torch.where(ov, fresh, pred)


###########################################
# ARI
###########################################


def adjusted_rand_index(true_ids, pred_ids, ignore_background=False):
    """[B] float64 numpy ARI of integer id masks [B, T, H, W] (or
    [B, H, W]); `ignore_background` drops true id 0 (FG-ARI)."""
    true_ids, pred_ids = _ids(true_ids), _ids(pred_ids)
    B = true_ids.shape[0]
    true_ids = true_ids.reshape(B, -1)
    pred_ids = pred_ids.reshape(B, -1).to(true_ids.device)
    n = contingency(true_ids, pred_ids, int(true_ids.max()) + 1,
                    int(pred_ids.max()) + 1)
    if ignore_background:
        n = n[:, 1:]
    a = n.sum(-1)  # [B, C]
    b = n.sum(-2)  # [B, K]
    num_points = a.sum(1)
    rindex = (n * (n - 1)).sum((1, 2))
    aindex = (a * (a - 1)).sum(1)
    bindex = (b * (b - 1)).sum(1)
    expected = aindex * bindex / torch.clamp(num_points * (num_points - 1),
                                             min=1)
    max_rindex = (aindex + bindex) / 2
    denom = max_rindex - expected
    ari = torch.where(denom != 0, (rindex - expected) / denom,
                      torch.ones_like(denom))
    return ari.cpu().numpy()


def ARI_metric(gt_mask, pred_mask, inst_overlap_mask=None):
    """Mean ARI of integer masks [B, H, W] (overlap pixels taken out with
    `inst_overlap_mask`)."""
    gt_mask, pred_mask = _apply_overlap(gt_mask, pred_mask,
                                        inst_overlap_mask)
    return float(adjusted_rand_index(gt_mask, pred_mask).mean())


def fARI_metric(gt_mask, pred_mask, inst_overlap_mask=None):
    """Mean foreground ARI: the ground truth's background (id 0) is
    ignored."""
    gt_mask, pred_mask = _apply_overlap(gt_mask, pred_mask,
                                        inst_overlap_mask)
    return float(adjusted_rand_index(gt_mask, pred_mask,
                                     ignore_background=True).mean())


###########################################
# Hungarian mIoU / mBO
###########################################


def _pairwise_ious(gt_mask, pred_mask, ignore_background):
    """Per image of [B, ...] integer masks: the [N, M] IoU matrix between
    its ground-truth classes (0..max, without 0 when ignoring the
    background) and its predicted classes (0..max), float64 numpy; None
    for an image whose ground truth is all background when ignoring it."""
    gt, pred = _ids(gt_mask), _ids(pred_mask)
    B = gt.shape[0]
    gt, pred = gt.reshape(B, -1), pred.reshape(B, -1).to(gt.device)
    n_gt = (gt.max(1).values + 1).tolist()
    n_pred = (pred.max(1).values + 1).tolist()
    inter = contingency(gt, pred, max(n_gt), max(n_pred))
    gt_area = inter.sum(2, keepdim=True)
    pred_area = inter.sum(1, keepdim=True)
    iou = (inter / (gt_area + pred_area - inter + 1e-8)).cpu().numpy()
    out = []
    for i in range(B):
        m = iou[i, :n_gt[i], :n_pred[i]]
        if ignore_background:
            m = None if n_gt[i] == 1 else m[1:]
        out.append(m)
    return out


def hungarian_miou(iou):
    """Hungarian-matched mean IoU of one [N, M] IoU matrix, with the
    undetected-object penalty when the prediction has fewer classes."""
    n, m = iou.shape
    row, col = linear_sum_assignment(iou, maximize=True)
    if m >= n:
        return float(iou[row, col].mean())
    return float(iou[row, col].sum() / n)


def mean_best_overlap(iou):
    """mBO of one foreground [N, M] IoU matrix: predictions may be
    reused."""
    return float(iou.max(1).mean())


def _nanmean(vals):
    vals = [np.nan if v is None else v for v in vals]
    if all(np.isnan(v) for v in vals):
        return np.nan
    return float(np.nanmean(vals))


def miou_metric(gt_mask, pred_mask, inst_overlap_mask=None):
    """Hungarian mIoU with the background; integer masks [B, H, W]."""
    gt_mask, pred_mask = _apply_overlap(gt_mask, pred_mask,
                                        inst_overlap_mask)
    return _nanmean([hungarian_miou(m) for m in
                     _pairwise_ious(gt_mask, pred_mask, False)])


def fmiou_metric(gt_mask, pred_mask, inst_overlap_mask=None):
    """Hungarian mIoU over the foreground ground-truth classes."""
    gt_mask, pred_mask = _apply_overlap(gt_mask, pred_mask,
                                        inst_overlap_mask)
    return _nanmean([None if m is None else hungarian_miou(m) for m in
                     _pairwise_ious(gt_mask, pred_mask, True)])


def mbo_metric(gt_mask, pred_mask, inst_overlap_mask=None):
    """Mean best overlap; integer masks [B, H, W]."""
    gt_mask, pred_mask = _apply_overlap(gt_mask, pred_mask,
                                        inst_overlap_mask)
    return _nanmean([None if m is None else mean_best_overlap(m) for m in
                     _pairwise_ious(gt_mask, pred_mask, True)])


###########################################
# Mask post-processing
###########################################


def postproc_mask(batch_masks):
    """Background-aware argmax of soft masks [B, T, N, H, W] -> int64
    [B, T, H, W]: on pixels where no slot reaches FG_THRE, the slot with
    the weakest peak wins (it takes score 1 there)."""
    m = torch.as_tensor(batch_masks).clone()
    B, T, N, H, W = m.shape
    m = m.reshape(B * T, N, H * W)
    bg_idx = m.max(-1).values.argmin(-1)  # [BT]
    low = m.max(1).values < FG_THRE       # [BT, HW]
    rows = torch.arange(B * T, device=m.device)
    sel = m[rows, bg_idx]
    sel[low] = 1.0
    m[rows, bg_idx] = sel
    return m.argmax(1).reshape(B, T, H, W)


def masks_to_boxes(masks, num_boxes=7):
    """Integer masks [B, T, H, W] -> float64 boxes [B, T, num_boxes, 4]:
    the (x1, y1, x2, y2) of the pixels of each id 0..num_boxes-1 in each
    frame, the last row and column inclusive; -1 four times where an id
    has no pixel (the JAX package's ops/metrics.py:295-316)."""
    m = _ids(masks)
    H, W = m.shape[-2:]
    onehot = m[..., None] == torch.arange(num_boxes, device=m.device)
    rows, cols = onehot.any(3), onehot.any(2)  # [B, T, H or W, N]
    ys = torch.arange(H, device=m.device)[:, None]
    xs = torch.arange(W, device=m.device)[:, None]
    boxes = torch.stack([
        torch.where(cols, xs, W).amin(2), torch.where(rows, ys, H).amin(2),
        torch.where(cols, xs, -1).amax(2), torch.where(rows, ys, -1).amax(2),
    ], dim=-1).double()
    return torch.where(rows.any(2)[..., None], boxes,
                       torch.full_like(boxes, -1.0))


###########################################
# Reconstruction quality
###########################################


def _f64(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def mse_metric(x, y):
    """Images [B, H, W, 3] in [0, 1]: the squared error summed over each
    image, averaged over the batch."""
    x, y = _f64(x), _f64(y)
    return float(((x - y) ** 2).reshape(x.shape[0], -1).sum(-1).mean())


def psnr_metric(x, y, data_range=1.0):
    """Images [B, H, W, 3] in [0, 1]: the mean PSNR of the images."""
    x, y = _f64(x), _f64(y)
    mse = np.maximum(((x - y) ** 2).reshape(x.shape[0], -1).mean(-1), 1e-12)
    return float(np.mean(10.0 * np.log10(data_range ** 2 / mse)))


def _ssim_single(x, y, data_range, sigma=1.5, truncate=3.5):
    """Gaussian-weighted SSIM of one [H, W] channel with the population
    covariance (skimage's `structural_similarity` with
    gaussian_weights=True, sigma=1.5, use_sample_covariance=False), the
    filter radius cropped from each border before the mean."""
    filt = lambda a: gaussian_filter(a, sigma, truncate=truncate)
    ux, uy = filt(x), filt(y)
    vx = filt(x * x) - ux * ux
    vy = filt(y * y) - uy * uy
    vxy = filt(x * y) - ux * uy
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    ssim = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    r = int(truncate * sigma + 0.5)
    if ssim.shape[0] > 2 * r and ssim.shape[1] > 2 * r:
        ssim = ssim[r:-r, r:-r]
    return ssim.mean()


def ssim_metric(x, y):
    """Images [B, H, W, 3] in [0, 1]: SSIM at 255 scale, averaged over
    the channels and the images."""
    x, y = _f64(x) * 255.0, _f64(y) * 255.0
    return float(np.mean([
        np.mean([_ssim_single(x[i, ..., c], y[i, ..., c], 255)
                 for c in range(x.shape[-1])])
        for i in range(x.shape[0])]))
