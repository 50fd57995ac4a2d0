'''
Evaluation: rating-prediction accuracy and top-N retrieval quality.

Re-design of reference ``mfrec/recommendation/metrics.py``: same metric
definitions (RMSE / MAE / NMAE on held-out [user, item, rating] rows;
P@N / R@N / F1 over per-user recommended-set intersections; fold-in
validation), but vectorized — pair scoring uses the model's batch
predictor when available instead of a per-pair python loop
(metrics.py:58-66).
'''
from __future__ import annotations

import numpy as np

from mfrec_tpu.models.base import Error
from mfrec_tpu.ops.topk import NEG as topk_NEG


def shannon_entropy(recommender, recommendations):
    '''Shannon entropy of the recommended-item distribution — item-space
    coverage (reference stub metrics.py:13-17, implemented).'''
    flat = np.concatenate([np.asarray(r) for r in recommendations])
    counts = np.bincount(flat.astype(int), minlength=recommender.nbr_items)
    p = counts / max(counts.sum(), 1)
    p = p[p > 0]
    return float(-(p * np.log2(p)).sum())


def test_predict_rating(recommender, u_test, nbr_samples=10, verbose=False,
                        predictor='predict_rating', quiet=False):
    '''RMSE/MAE/NMAE over held-out ratings (reference metrics.py:51-82).
    u_test: [n, 3] array of (user, item, rating).  Returns (rmse, errors).'''
    rows = np.asarray(u_test)[0:nbr_samples]
    users = rows[:, 0].astype(int)
    items = rows[:, 1].astype(int)
    real = rows[:, 2].astype(np.float64)

    if hasattr(recommender, 'predict_batch'):
        try:
            pred = np.asarray(
                recommender.predict_batch(items, users, predictor),
                np.float64)
        except KeyError:
            pred = None
    else:
        pred = None
    if pred is None:
        pred_list, real_list = [], []
        fn = getattr(recommender, predictor)
        for u, i, r in zip(users, items, real):
            try:
                pred_list.append(float(fn(int(i), int(u))))
                real_list.append(r)
            except Error:
                pass
        pred = np.asarray(pred_list)
        real = np.asarray(real_list)

    errors = real - pred
    errors = errors[~np.isnan(errors)]
    abs_errors = np.abs(errors)
    if abs_errors.size == 0:
        # Every prediction failed/NaN'd (e.g. a kNN predictor with
        # k < k_min finds no usable neighbors) — return NaN explicitly
        # instead of tripping numpy's empty-slice RuntimeWarning.
        if not quiet:
            print('Number of succesful rating: 0/%d' % nbr_samples)
        return float('nan'), errors
    rmse = float(np.sqrt((abs_errors ** 2).mean()))
    if not quiet:
        print('Number of succesful rating: %d/%d'
              % (len(abs_errors), nbr_samples))
        print('Mean abs. error: %s' % abs_errors.mean())
        print('Variance of the error: %s' % abs_errors.var())
        print('Mean root mean square error (RMSE): %s' % rmse)
        print('NMAE: %s' % (abs_errors.mean() / 1.6))
        print('MAE: %s' % abs_errors.mean())
    return rmse, errors


def test_predict_rating2(recommender, u_test, item_map, nbr_samples=10,
                         predictor='predict_rating', verbose=False):
    '''Variant with an item-id remap dict (reference metrics.py:19-48).'''
    rows = np.asarray(u_test)[0:nbr_samples]
    remapped = rows.copy()
    keep = []
    for j, row in enumerate(rows):
        try:
            remapped[j, 1] = item_map[int(row[1])]
            keep.append(j)
        except KeyError:
            pass
    return test_predict_rating(recommender, remapped[keep],
                               nbr_samples=len(keep), predictor=predictor,
                               verbose=verbose, quiet=not verbose)


def precision_recall(recommender, u_test, nbr_recommendations=5,
                     predictor='predict', verbose=False):
    '''P@N / R@N / F1 over per-user recommendations vs. held-out positives
    (reference metrics.py:85-130).'''
    test_sample_dict = {}
    for rating in np.asarray(u_test):
        test_sample_dict.setdefault(int(rating[0]), []).append(int(rating[1]))

    precision = recall = 0.0
    users_count = 0
    for user_index in test_sample_dict.keys():
        if user_index >= recommender.nbr_users:
            continue
        try:
            recommended = recommender.find_recommended_items(
                user_index=user_index,
                nbr_recommendations=nbr_recommendations,
                output_label=False, predictor=predictor)[0]
            recommended_set = set(recommended)
            users_count += 1
        except (KeyError, Error):
            continue
        already_rated = set(test_sample_dict[user_index])
        inter = float(len(recommended_set.intersection(already_rated)))
        precision += inter / nbr_recommendations
        recall += inter / len(already_rated)

    precision /= max(users_count, 1)
    recall /= max(users_count, 1)
    denom = precision + recall
    f_measure = 2 * precision * recall / denom if denom else 0.0
    if verbose:
        print('Precision @ %d : %s' % (nbr_recommendations, precision))
        print('Recall @ %d : %s' % (nbr_recommendations, recall))
        print('F-Measure : %s' % f_measure)
    return precision, recall, f_measure


def folding_in_test(recommender_factory, u, u_test, ratio=0.10,
                    predictor='predict_rating', nbr_samples=20000, seed=0):
    '''Fold-in validation (reference metrics.py:133-208, completed): remove
    `ratio` of users, retrain from scratch, fold the removed users back in
    via add_user, and report RMSE on the full and pruned test sets at each
    stage.  `recommender_factory()` must build a fresh configured model.
    Returns a dict of stage -> rmse.'''
    u = np.asarray(u)
    u_test = np.asarray(u_test)
    rng = np.random.default_rng(seed)
    all_users = np.unique(u[:, 0].astype(int))
    n_remove = max(int(len(all_users) * ratio), 1)
    removed = set(rng.permutation(all_users)[:n_remove].tolist())

    in_removed_train = np.isin(u[:, 0].astype(int), list(removed))
    in_removed_test = np.isin(u_test[:, 0].astype(int), list(removed))
    prune_train = u[~in_removed_train]
    prune_test = u_test[in_removed_test]

    results = {}
    model = recommender_factory()
    for row in prune_train:
        model.set_item_by_id(int(row[0]), int(row[1]), float(row[2]))
    model.train()
    results['pruned_model_full_test'] = test_predict_rating(
        model, u_test, nbr_samples, predictor=predictor, quiet=True)[0]
    results['pruned_model_pruned_test'] = test_predict_rating(
        model, prune_test, nbr_samples, predictor=predictor, quiet=True)[0]

    for user_index in removed:
        rows = u[u[:, 0].astype(int) == user_index]
        if rows.shape[0] == 0:
            continue
        model.add_user('newuser%d' % user_index,
                       rows[:, 1].astype(np.int32),
                       rows[:, 2].astype(np.float32))
        # map the original user id onto the folded-in row for eval
        model.users.index['user%d' % user_index] = \
            model.users.index['newuser%d' % user_index]

    # Rebuild test arrays against folded-in ids
    folded_test = u_test.copy()
    for j in range(folded_test.shape[0]):
        uid = int(folded_test[j, 0])
        if uid in removed:
            folded_test[j, 0] = model.users.index['newuser%d' % uid]
    results['folded_model_full_test'] = test_predict_rating(
        model, folded_test, nbr_samples, predictor=predictor, quiet=True)[0]
    results['folded_model_pruned_test'] = test_predict_rating(
        model, folded_test[in_removed_test], nbr_samples,
        predictor=predictor, quiet=True)[0]
    return results


def ranking_metrics(recommender, u_test, nbr_recommendations=10,
                    predictor='predict', relevance_threshold=0.0,
                    verbose=False):
    '''Ranked-list quality beyond the reference's P@N/R@N: NDCG@N, MAP@N,
    MRR and catalog coverage over per-user recommendations (production
    serving metrics; the reference stops at precision_recall,
    metrics.py:85-130).

    u_test: [n, 3] (user, item, rating) held-out rows; rows with rating
    > ``relevance_threshold`` count as relevant (all rows for implicit
    data).  Returns dict(ndcg, map, mrr, coverage, users).
    '''
    relevant_by_user = {}
    for row in np.asarray(u_test):
        if float(row[2]) > relevance_threshold:
            relevant_by_user.setdefault(int(row[0]), set()).add(int(row[1]))

    N = int(nbr_recommendations)
    discounts = 1.0 / np.log2(np.arange(2, N + 2))
    ndcg_sum = ap_sum = rr_sum = 0.0
    users_count = 0
    recommended_union = set()

    eligible = [u for u in relevant_by_user
                if 0 <= u < recommender.nbr_users]
    # one batched device call per 1024 users where the model provides the
    # serving path (recommend_batch) — a per-user find_recommended_items
    # loop pays one full-catalog dispatch per user, minutes of overhead
    # at real test-set sizes
    recs = {}
    if hasattr(recommender, 'recommend_batch'):
        for s in range(0, len(eligible), 1024):
            chunk = eligible[s:s + 1024]
            try:
                ids, sc = recommender.recommend_batch(
                    np.asarray(chunk, np.int64), nbr_recommendations=N,
                    predictor=predictor)
            except (KeyError, Error):
                # keep already-computed chunks; only THIS chunk's users
                # fall back to the per-user path below
                continue
            ids, sc = np.asarray(ids), np.asarray(sc)
            for j, u in enumerate(chunk):
                # drop NEG-scored filler slots (a user with fewer than N
                # unrated items gets id-0 padding from the device top-n
                # init) — find_recommended_items filters the same way,
                # and a phantom id-0 "recommendation" would inflate
                # NDCG/MRR/coverage whenever item 0 is relevant
                live = sc[j] > topk_NEG / 2
                recs[u] = np.asarray(ids[j])[live].tolist()
    for user_index in eligible:
        relevant = relevant_by_user[user_index]
        if user_index in recs:
            recommended = recs[user_index]
        else:
            try:
                recommended = recommender.find_recommended_items(
                    user_index=user_index, nbr_recommendations=N,
                    output_label=False, predictor=predictor)[0]
            except (KeyError, Error):
                continue
        users_count += 1
        recommended = [int(i) for i in recommended][:N]
        recommended_union.update(recommended)
        hits = np.array([i in relevant for i in recommended], bool)
        if not hits.any():
            continue
        # NDCG@N: binary gains, ideal = all |relevant| (capped at N) first
        dcg = float(discounts[:len(hits)][hits].sum())
        ideal = float(discounts[:min(len(relevant), N)].sum())
        ndcg_sum += dcg / ideal
        # MAP@N: mean over relevant of precision at each hit rank
        ranks = np.nonzero(hits)[0] + 1
        precisions = np.arange(1, len(ranks) + 1) / ranks
        ap_sum += float(precisions.sum()) / min(len(relevant), N)
        # MRR: first hit rank
        rr_sum += 1.0 / float(ranks[0])

    out = {
        'ndcg': ndcg_sum / max(users_count, 1),
        'map': ap_sum / max(users_count, 1),
        'mrr': rr_sum / max(users_count, 1),
        'coverage': len(recommended_union) / max(recommender.nbr_items, 1),
        'users': users_count,
    }
    if verbose:
        print('NDCG@%d : %s' % (N, out['ndcg']))
        print('MAP@%d : %s' % (N, out['map']))
        print('MRR : %s' % out['mrr'])
        print('Catalog coverage : %s' % out['coverage'])
    return out
